"""repro_torch.obs — the dependency-free flight recorder.

``metrics``: process-wide counters/gauges/histograms with snapshot/
delta semantics and Prometheus text exposition.  ``trace``: span/event
tracing on an injectable clock, exported as Chrome trace-event JSON
(Perfetto-loadable).  ``record``: the FlightRecorder tying both to
per-round engine records; ``report``: the session-summary renderer
(``python -m repro_torch.obs.report session.json``).

Nothing here imports torch/numpy — instrumented hot paths pay one
attribute read when recording is off.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               registry)
from repro_torch.obs.record import (FlightRecorder, RoundRecord, get_recorder,
                              install, load_session, metrics_to_json,
                              recording)
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "FlightRecorder", "RoundRecord", "get_recorder", "install",
    "load_session", "metrics_to_json", "recording",
    "Span", "Tracer",
]
