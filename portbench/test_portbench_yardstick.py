"""The yardstick's arithmetic, the import check and the harness's lookup
by name, on the CPU."""
import json
import math
import pathlib
import subprocess
import sys
import textwrap

import pytest

from benchlib import bounds, cli, spec
from benchlib.stats import Reservoir, percentile

HERE = pathlib.Path(__file__).parent


def test_percentile_is_nearest_rank_over_all_requests():
    vals = list(range(1, 101))
    assert percentile(vals, 95) == 95
    assert percentile(vals, 100) == 100
    assert percentile([7.0], 95) == 7.0
    # six failures in a hundred push the 95th percentile to infinity
    assert percentile(vals[:94] + [math.inf] * 6, 95) == math.inf
    assert percentile(vals[:95] + [math.inf] * 5, 95) == 95
    assert math.isnan(percentile([], 95))


def test_reservoir_keeps_k_uniformly_from_the_seed():
    a, b = Reservoir(8, 3), Reservoir(8, 3)
    for i in range(1000):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(a.items) == 8 and a.seen == 1000
    hits = [0] * 10
    for seed in range(400):
        r = Reservoir(5, seed)
        for i in range(10):
            r.offer(i)
        for i in r.items:
            hits[i] += 1
    assert all(abs(h / 400 - 0.5) < 0.1 for h in hits)


def test_byte_bounds_count_from_the_graph():
    # a BFS that reached 3 vertices with 5 edges out of them on n = 8:
    # 5 ids, 3 x (2 offsets + value read + value written), 8 results
    assert bounds.search_bytes(8, 3, 5, False) == 5 * 4 + 3 * 16 + 8 * 4
    # SSSP reads each edge's weight too
    assert bounds.search_bytes(8, 3, 5, True) == 5 * 8 + 3 * 16 + 8 * 4
    # a query among 4 lanes shares its edges and offsets, not its values
    assert bounds.search_bytes(8, 3, 5, True, lanes=4) == \
        (5 * 8 + 3 * 8) / 4 + 3 * 8 + 8 * 4
    assert bounds.pagerank_bytes(8, 20, 3) == 3 * (20 * 4 + 8 * 20)
    assert bounds.bound_seconds(3.35e12) == pytest.approx(1.0)


def test_teps_and_rates_read_from_facts():
    read = {m: spec.load_reader(HERE, m) for m in (
        "traversal_gteps", "pagerank_gteps", "queries_per_s",
        "query_p95_ms.serve", "host_syncs_per_fixpoint.traversal",
        "ms_per_tick.serve", "occupancy.serve", "device_idle_pct.serve",
        "device_roofline_pct.pagerank", "setup_s", "partition_s")}
    facts = {"window_s": 2.0, "fixpoints": 4, "teps_edges": 6e9,
             "host_syncs": 10, "setup_s": 5.0, "partition_s": 3.0}
    assert read["traversal_gteps"](facts) == 3.0
    assert read["host_syncs_per_fixpoint.traversal"](facts) == 2.5
    assert read["pagerank_gteps"](facts) is None
    assert read["queries_per_s"](facts) is None
    assert read["setup_s"](facts) == 5.0 and read["partition_s"](facts) == 3.0
    serve = {"window_s": 2.0, "queries_ok": 300, "ticks": 400,
             "latencies_ms": [float(i) for i in range(1, 101)],
             "occupancy": 0.75,
             "trace": {"busy_s": 0.5, "device_s": 0.5, "window_s": 2.0}}
    assert read["queries_per_s"](serve) == 150.0
    assert read["query_p95_ms.serve"](serve) == 95.0
    assert read["ms_per_tick.serve"](serve) == 5.0
    assert read["occupancy.serve"](serve) == 75.0
    assert read["device_idle_pct.serve"](serve) == 75.0
    pr = {"window_s": 1.0, "pagerank_runs": 2, "pagerank_edge_iters": 4e9,
          "bound_bytes": 3.35e11,
          "trace": {"busy_s": 0.4, "device_s": 0.5, "window_s": 1.0}}
    assert read["pagerank_gteps"](pr) == 4.0
    assert read["device_roofline_pct.pagerank"](pr) == pytest.approx(20.0)
    # nothing to read: no number, never a 0
    assert read["device_roofline_pct.pagerank"]({"window_s": 1.0}) is None


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
            "repro.apps", "repro_torch", "repro_torch.apps", "reproducible",
            "jaxtyping", "torch"]
    assert cli.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "repro",
        "repro.apps"]


def test_harness_and_port_paths_load_no_jax_and_no_repro():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent / 'src')!r}]
        import pathlib
        from benchlib import check, cli, port, reference, spec, traffic
        for name in ("calls", "serve"):
            spec.load_driver(pathlib.Path({str(HERE)!r}), name)
        import repro_torch.apps, repro_torch.query, repro_torch.obs
        import repro_torch.core.partition, repro_torch.graph.graph
        print(cli.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "parmat-s22-traversal", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=HERE.parent, env={"CUDA_VISIBLE_DEVICES": "",
                              "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _throwaway_bench(tmp_path):
    """A throwaway configuration, traffic mix of a new shape with its
    driver, and metric, each a file of its own, made a cell by entries in
    BENCHMARK.json alone."""
    bench_dir = tmp_path / "bench"
    for sub in ("configs", "traffic", "drivers", "metrics"):
        (bench_dir / sub).mkdir(parents=True)
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(
        {"scale": 5, "edge_factor": 4, "a": 0.45, "b": 0.25, "c": 0.15,
         "d": 0.15, "drop_duplicates": True,
         "weight": {"kind": "integer", "low": 1, "high": 10}}))
    (bench_dir / "traffic" / "burst.json").write_text(json.dumps(
        {"driver": "degrees", "top": 3, "limits": {"hub_mismatch": 0}}))
    (bench_dir / "drivers" / "degrees.py").write_text(textwrap.dedent("""
        import torch
        CONTROLS = ("flipped",)

        def run(r, g):
            deg = g.out_degrees()
            top = torch.topk(deg, r.traffic["top"]).values
            want = torch.sort(deg, descending=True).values[:len(top)]
            facts = {"window_s": 1.0, "attempted": 1, "failed": 0,
                     "teps_edges": int(top.sum())}
            readings = {None: {"hub_mismatch": int((top != want).sum())}}
            for c in r.controls:
                readings[c] = {"hub_mismatch": int(
                    (top.flip(0) != want).sum())}
            return facts, readings
    """))
    (bench_dir / "metrics" / "edges_seen.py").write_text(
        "def read(facts):\n    return facts.get('teps_edges')\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "tiny", "file": "bench/configs/tiny.json"}],
        "workloads": [{"name": "tiny.burst", "config": "tiny",
                       "traffic": "burst", "chips": 1}],
        "end_to_end": [{"name": "edges_seen.burst", "unit": "edges",
                        "workloads": ["tiny.burst"]},
                       {"name": "edges_seen.other", "unit": "edges",
                        "workloads": ["other"]}],
        "per_layer": []}))
    return bench_dir


def test_pieces_added_as_files_are_found_without_an_edit(tmp_path):
    bench_dir = _throwaway_bench(tmp_path)
    cell = spec.load_cell(tmp_path, bench_dir, "tiny.burst", trace=False)
    assert cell.config["scale"] == 5
    assert cell.traffic["top"] == 3 and cell.driver.CONTROLS == ("flipped",)
    assert [m.name for m in cell.metrics] == ["edges_seen.burst"]
    assert cli.metrics_of(cell, {"teps_edges": 12}) == {
        "edges_seen.burst": {"value": 12, "unit": "edges"}}
    with pytest.raises(FileNotFoundError):
        spec.load_reader(bench_dir, "missing_metric")
    with pytest.raises(FileNotFoundError):
        spec.load_driver(bench_dir, "missing_driver")


def test_traffic_driver_added_as_a_file_runs_and_is_checked(tmp_path):
    """A traffic of a new shape runs through the shared generator and
    check: its program reads correct, its control not."""
    import time

    import torch

    from benchlib import check, traffic

    bench_dir = _throwaway_bench(tmp_path)
    cell = spec.load_cell(tmp_path, bench_dir, "tiny.burst", trace=False)
    facts, readings = traffic.run(traffic.Run(
        cell.config, cell.traffic, cell.driver, 2**31 + 5, 0.1, False,
        torch.device("cpu"), time.perf_counter(), controls=("flipped",)))
    limits = cell.traffic["limits"]
    assert check.verdict(readings[None], limits)[0] is True
    assert check.verdict(readings["flipped"], limits)[0] is False
    assert cli.metrics_of(cell, facts)["edges_seen.burst"]["value"] > 0
    with pytest.raises(ValueError):
        traffic.run(traffic.Run(
            cell.config, cell.traffic, cell.driver, 1, 0.1, False,
            torch.device("cpu"), time.perf_counter(), controls=("bf16",)))


def test_benchmark_json_names_a_reader_for_every_metric():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(HERE, m["name"]))
    for w in bench["workloads"]:
        for trace in (False, True):
            cell = spec.load_cell(HERE.parent, HERE, w["name"], trace)
            assert cell.metrics


def test_trace_reduction_sums_busy_time_and_names_gaps():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from benchlib.trace import reduce_events

    def ev(name, t0, t1, dev=DeviceType.CUDA):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=t0, end=t1))
    events = [ev("k1", 0, 100), ev("copy", 50, 150),     # overlap: busy 150
              ev("k2", 400, 500),                        # 250 idle before
              ev("host", 0, 10_000, DeviceType.CPU),     # not the device's
              ev("k1", 600, 700)]                        # 100 idle before
    r = reduce_events(events)
    assert r["busy_s"] == pytest.approx(350e-6)
    assert r["device_s"] == pytest.approx(400e-6)
    assert r["ops"][0] == ["k1", pytest.approx(200e-6)]
    assert dict((k, v) for k, v in r["gaps"]) == {
        "k2": pytest.approx(250e-6), "k1": pytest.approx(100e-6)}
