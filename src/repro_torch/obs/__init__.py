"""repro_torch.obs — the dependency-free flight recorder.

``metrics``: process-wide counters/gauges/histograms with snapshot/
delta semantics and Prometheus text exposition.  ``trace``: span/event
tracing exported as Chrome trace-event JSON (Perfetto-loadable), stamped
by default on ``torch.profiler``'s clock (Unix-epoch ns, the tracer's
``epoch_ns``), each span with an ``id`` and, on its thread's stack, a
``parent``.  ``record``: the FlightRecorder tying both to per-round
engine records, or to spans and counters alone
(``FlightRecorder(rounds=False)``: the engine's loops then run exactly
as with no recorder); ``report``: the session-summary renderer
(``python -m repro_torch.obs.report session.json``).

The spans the port records, by layer (track in brackets):

- partition [``partition``]: ``partition.placement``,
  ``partition.assemble`` (``core.partition.build_partition``);
- app [``app``]: ``app.call`` (args ``app``, ``root``) around
  ``apps.bfs`` / ``sssp`` / ``pagerank`` / ``bfs_tree`` / ``sssp_tree``;
  ``engine.upload`` (``DeviceArrays.from_partition``) with its child
  ``engine.plan`` (``plan_launch``), or, arg ``resident``,
  ``engine.device_arrays`` finding a partition's tables on the device
  already (counted by
  ``engine_device_tables_total``, ``result`` ``upload`` or ``hit``);
  ``engine.init`` (the initial tensors put on the
  device in ``run_stacked`` / ``run_pagerank_stacked``); ``app.extract``
  (``engine.vertex_values`` as the apps call it); ``app.tree`` (arg
  ``app``: ``apps.bfs_tree`` / ``sssp_tree``'s parent pass, K10, and its
  read; counted by ``tree_passes_total{app}``, its tie rounds by
  ``tree_tie_rounds_total{app}``);
- engine driver [``engine/<run>``]: ``engine.window`` (one
  ``device_worklist`` window) with its child ``engine.read`` (the
  window's one host read); ``engine.iterations`` (PageRank's rounds);
  ``round`` (a host-driven round, under round accounting only);
- server [``server``; requests on ``requests``]: ``server.tick`` with
  its children ``server.admit`` (``_admit``, injection included),
  ``server.step`` (a pool's live-flag read, step and counts read) and
  ``server.retire`` (``_retire``, extraction included); ``queued`` and
  ``run`` per request, sharing its ``qid``.

Nothing here imports torch/numpy — instrumented hot paths pay one
attribute read when recording is off.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               registry)
from repro_torch.obs.record import (FlightRecorder, RoundRecord, get_recorder,
                              install, load_session, metrics_to_json,
                              recording, round_recorder, span)
from repro_torch.obs.trace import Span, Tracer, self_times

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "FlightRecorder", "RoundRecord", "get_recorder", "install",
    "load_session", "metrics_to_json", "recording", "round_recorder",
    "span", "Span", "Tracer", "self_times",
]
