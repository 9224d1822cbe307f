"""Run-summary renderer for recorded flight-recorder sessions.

``python -m repro_torch.obs.report session.json`` prints, per recorded run:
rounds, the live-frontier trajectory, messages (delivered / pruned),
exact grid cells and DMA bytes (the planner mirror), the kernel path
chosen (pinned/tiled × dense/worklist), wall time, and the per-shard
message skew (max/mean, 1.0 = perfectly balanced) — then the serving
counters (request statuses, cache hits/misses/invalidations,
preemptions, queue depth) when a server ran under the same recorder.

``render(session)`` returns the same text for programmatic use (the
quickstart and the tests call it on an in-memory session dict).
"""
from __future__ import annotations

import sys

from repro_torch.obs.record import _skew, load_session


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _metric_series(session: dict, name: str) -> list:
    for entry in session.get("metrics", []):
        if entry["name"] == name:
            return entry["series"]
    return []


def _runs(rounds: list) -> dict:
    by_run: dict[str, list] = {}
    for r in rounds:
        by_run.setdefault(r["run"], []).append(r)
    return by_run


def render(session: dict) -> str:
    lines = []
    meta = session.get("meta") or {}
    if meta:
        kv = " ".join(f"{k}={v}" for k, v in sorted(meta.items()))
        lines.append(f"session: {kv}")

    rounds = session.get("rounds", [])
    if rounds:
        lines.append("== engine rounds ==")
    for run, rows in _runs(rounds).items():
        msgs = sum(r["messages"] for r in rows)
        pruned = sum(r["pruned"] for r in rows)
        cells = sum(r["cells"] for r in rows)
        dma = sum(r["dma_bytes"] for r in rows)
        wall = sum(r["wall_s"] for r in rows)
        paths = sorted({f"{r['grid']}/{r['path']}" for r in rows})
        lines.append(
            f"{run}: rounds={len(rows)} "
            f"frontier {rows[0]['frontier']}->{rows[-1]['frontier']} "
            f"messages={msgs} pruned={pruned} cells={cells} "
            f"dma={_fmt_bytes(dma)} wall={wall * 1e3:.1f}ms "
            f"path={','.join(paths)}")
        shard_rows = [r["shard_messages"] for r in rows
                      if r.get("shard_messages")]
        if shard_rows:
            S = len(shard_rows[0])
            totals = [sum(row[s] for row in shard_rows) for s in range(S)]
            skew = _skew(totals)
            mean = sum(totals) / max(len(totals), 1)
            lines.append(
                f"  shard messages: S={S} max={max(totals)} "
                f"mean={mean:.1f} skew(max/mean)={skew:.2f}")

    serve = {}
    for metric in ("serve_requests_total", "serve_cache_total",
                   "serve_preemptions_total", "serve_ticks_total"):
        series = _metric_series(session, metric)
        if series:
            serve[metric] = series
    if serve:
        lines.append("== serving ==")
        for row in serve.get("serve_requests_total", []):
            status = row["labels"].get("status", "?")
            lines.append(f"requests[{status}] = {row['value']}")
        for row in serve.get("serve_cache_total", []):
            ev = row["labels"].get("event", "?")
            lines.append(f"cache[{ev}] = {row['value']}")
        for row in serve.get("serve_preemptions_total", []):
            lines.append(f"preemptions = {row['value']}")
        for row in serve.get("serve_ticks_total", []):
            lines.append(f"server ticks = {row['value']}")
        depth = _metric_series(session, "serve_queue_depth")
        for row in depth:
            lines.append(f"queue depth (last) = {row['value']}")

    trace = session.get("trace", {})
    events = trace.get("traceEvents", [])
    spans = sum(1 for e in events if e.get("ph") == "X")
    if events:
        lines.append(f"trace: {len(events)} events ({spans} spans) — "
                     "load the session's 'trace' object in Perfetto")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.report <session.json>",
              file=sys.stderr)
        return 2
    print(render(load_session(argv[0])), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
