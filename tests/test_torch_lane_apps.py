"""The port's lane-built apps against the reference's and the numpy
oracles: connected components, multi-source BFS/SSSP, personalized
PageRank and lane-batched delta-PPR, on the same partitions.

Min lanes are bit-identical with equal ``LaneStats``.  PPR scores are
held to the reference tests' tolerance (rtol 1e-4 / atol 1e-7).  Round
counts are compared at a tolerance well above float32 rounding of the
scores: at the reference test's tol 1e-9 a lane's last deltas are a few
ulps of its scores (1e-9 .. 4e-9), so the two packages' summation orders
decide the last round; at tol 1e-6 every lane's final delta is several
percent away from tol.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import apps as ref_apps  # noqa: E402
from repro.apps.pagerank import _pr_graph as ref_pr_graph  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro.query import lanes as ref_lanes  # noqa: E402
from repro_torch import apps, interop  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.graph import generators, reference  # noqa: E402
from repro_torch.graph.graph import COOGraph  # noqa: E402
from repro_torch.query import lanes  # noqa: E402

GRID_MODES = ["dense", "worklist", "auto", "device_worklist"]
PPR_RTOL, PPR_ATOL = 1e-4, 1e-7


def _lane_stats(stats):
    return {f: [int(x) for x in np.asarray(getattr(stats, f))]
            for f in stats._fields}


def _shared_partition(g_ref, shards, rpvo):
    part_ref = ref_partition.build_partition(
        g_ref, ref_partition.PartitionConfig(num_shards=shards,
                                             rpvo_max=rpvo))
    return part_ref, interop.partition_from_dict(
        dataclasses.asdict(part_ref))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_connected_components_match_reference(use_pallas):
    g_ref = ref_generators.erdos_renyi(220, avg_degree=2.0, seed=11)
    g = generators.erdos_renyi(220, avg_degree=2.0, seed=11)
    want, want_stats, _ = ref_apps.cc(
        g_ref, num_shards=4, rpvo_max=2,
        cfg=ref_engine.EngineConfig(use_pallas=use_pallas))
    got, stats, _ = apps.cc(g, num_shards=4, rpvo_max=2, device="cpu",
                            cfg=engine.EngineConfig(use_pallas=use_pallas))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, reference.connected_components(g))
    assert _lane_stats(stats) == _lane_stats(want_stats)
    assert int(stats.rounds[0]) > 1


def test_connected_components_disconnected_graph():
    """Two disjoint rings -> two labels (the min vertex id of each)."""
    r = 20
    src = np.concatenate([np.arange(r), np.arange(r) + r]).astype(np.int32)
    dst = np.concatenate([(np.arange(r) + 1) % r,
                          (np.arange(r) + 1) % r + r]).astype(np.int32)
    labels, _, _ = apps.cc(COOGraph(2 * r, src, dst, None), num_shards=4,
                           device="cpu")
    assert set(labels[:r]) == {0} and set(labels[r:]) == {r}


@pytest.mark.parametrize("grid_mode", ["dense", "device_worklist"])
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_multi_source_matches_reference_and_oracle(kind, grid_mode):
    g_ref = ref_generators.rmat(8, edge_factor=4, seed=13) \
        .with_random_weights(seed=13)
    g = generators.rmat(8, edge_factor=4, seed=13).with_random_weights(
        seed=13)
    deg = np.argsort(-g.out_degrees())
    roots = [int(deg[0]), int(deg[3]), int(deg[9])]
    part_ref, part = _shared_partition(g_ref, 4, 2)
    kw = dict(use_pallas=True, grid_mode=grid_mode)
    fn = f"multi_source_{kind}"
    want, want_stats, _ = getattr(ref_apps, fn)(
        g_ref, roots, part=part_ref, cfg=ref_engine.EngineConfig(**kw))
    got, stats, _ = getattr(apps, fn)(g, roots, part=part, device="cpu",
                                      cfg=engine.EngineConfig(**kw))
    np.testing.assert_array_equal(got, want)
    assert _lane_stats(stats) == _lane_stats(want_stats)
    oracle = reference.bfs_levels if kind == "bfs" \
        else reference.sssp_dijkstra
    np.testing.assert_array_equal(
        got, np.stack([oracle(g, r) for r in roots]).min(axis=0))


def _ppr_case():
    g_ref = ref_generators.rmat(7, edge_factor=5, seed=3)
    g = generators.rmat(7, edge_factor=5, seed=3)
    deg = np.argsort(-g.out_degrees())
    part_ref, part = _shared_partition(ref_pr_graph(g_ref), 4, 2)
    return g_ref, g, [int(deg[0]), int(deg[2])], [0.85, 0.6], part_ref, \
        part


@pytest.mark.parametrize("use_pallas", [False, True])
def test_personalized_pagerank_matches_reference_and_oracle(use_pallas):
    g_ref, g, seeds, dampings, part_ref, part = _ppr_case()
    cfg = dict(use_pallas=use_pallas)
    got, _, _ = apps.personalized_pagerank(
        g, seeds, dampings, part=part, tol=1e-9, device="cpu",
        cfg=engine.EngineConfig(**cfg))
    want, _, _ = ref_apps.personalized_pagerank(
        g_ref, seeds, dampings, part=part_ref, tol=1e-9,
        cfg=ref_engine.EngineConfig(**cfg))
    np.testing.assert_allclose(got, want, rtol=PPR_RTOL, atol=PPR_ATOL)
    for q, (s, d) in enumerate(zip(seeds, dampings)):
        oracle = reference.personalized_pagerank(g, s, d, tol=1e-12)
        np.testing.assert_allclose(got[:, q], oracle, rtol=PPR_RTOL,
                                   atol=PPR_ATOL)
    # rounds and messages, at a tol clear of float32 rounding
    _, stats, _ = apps.personalized_pagerank(
        g, seeds, dampings, part=part, tol=1e-6, device="cpu",
        cfg=engine.EngineConfig(**cfg))
    _, want_stats, _ = ref_apps.personalized_pagerank(
        g_ref, seeds, dampings, part=part_ref, tol=1e-6,
        cfg=ref_engine.EngineConfig(**cfg))
    assert _lane_stats(stats) == _lane_stats(want_stats)
    assert int(stats.rounds[1]) < int(stats.rounds[0])


@pytest.mark.parametrize("grid_mode", GRID_MODES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_ppr_delta_lanes_match_reference(use_pallas, grid_mode):
    _, g, seeds, dampings, part_ref, part = _ppr_case()
    kw = dict(use_pallas=use_pallas, grid_mode=grid_mode)
    want, want_stats = ref_lanes.run_ppr_delta_lanes(
        part_ref, seeds, dampings, ref_engine.EngineConfig(**kw), tol=1e-7)
    got, stats = lanes.run_ppr_delta_lanes(
        part, seeds, dampings, engine.EngineConfig(**kw), tol=1e-7,
        device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=PPR_RTOL, atol=PPR_ATOL)
    assert _lane_stats(stats) == _lane_stats(want_stats)
    for q, (s, d) in enumerate(zip(seeds, dampings)):
        scores = engine.vertex_values(part, got[..., q])
        oracle = reference.personalized_pagerank(g, s, d, tol=1e-12)
        np.testing.assert_allclose(scores, oracle, rtol=1e-3, atol=1e-6)


def test_ppr_round_freezes_dead_lanes():
    """A lane marked dead carries its scores through and sends nothing."""
    _, _, seeds, dampings, _, part = _ppr_case()
    round_fn = lanes.make_ppr_round(part, device="cpu")
    base = torch.as_tensor(lanes.ppr_base_table(part, seeds, dampings))
    val = base.clone()
    live = torch.tensor([True, False])
    new, delta, counts = round_fn(val, base, torch.tensor(dampings), live)
    assert torch.equal(new[..., 1], val[..., 1])
    assert float(delta[1]) == 0.0 and int(counts[1]) == 0
    assert int(counts[0]) > 0
