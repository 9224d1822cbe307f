"""The port's cycle-level AM-CCA simulator and analytic cost model against
the reference's, field for field and exactly, on the reference's own
configs (``tests/test_amcca_sim.py``, the simulator runs of
``benchmarks/fig6.py`` and ``fig10.py`` and a cut-down ``fig8.py``
replay), with the simulator's values also held to the port's numpy
oracles; and the ``frontier_relax_ref`` oracle against the reference's.
Both packages run on the same partition (``interop.partition_from_dict``);
the port runs on the CPU (``device="cpu"``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.amcca_sim import AmccaSim as RefSim  # noqa: E402
from repro.core.costmodel import CostModel as RefCostModel  # noqa: E402
from repro.core.partition import (  # noqa: E402
    PartitionConfig as RefPartitionConfig, build_partition as ref_build)
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph import reference as ref_oracle  # noqa: E402
from repro.graph.graph import COOGraph as RefCOOGraph  # noqa: E402
from repro.kernels import ref as ref_kref  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.amcca_sim import AmccaSim, SimResult  # noqa: E402
from repro_torch.core.costmodel import CostModel, CostResult  # noqa: E402
from repro_torch.graph import reference  # noqa: E402
from repro_torch.graph.graph import COOGraph  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402


def _port_part(part):
    return interop.partition_from_dict(dataclasses.asdict(part))


def _port_graph(g):
    return COOGraph(g.n, g.src, g.dst, g.weight)


def _assert_equal(ref_res, port_res):
    """Every field equal: arrays exactly, with dtype and shape; scalars
    exactly, with type."""
    assert [f.name for f in dataclasses.fields(ref_res)] == \
        [f.name for f in dataclasses.fields(port_res)]
    for f in dataclasses.fields(ref_res):
        want, got = getattr(ref_res, f.name), getattr(port_res, f.name)
        if isinstance(want, np.ndarray):
            got = got.cpu().numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert got == want, (f.name, got, want)
            assert type(got) is type(want) or (
                isinstance(want, np.integer) and isinstance(got, int)), \
                (f.name, type(got), type(want))


def _sim_pair(g, pcfg, torus, sources, weights):
    part = ref_build(g, pcfg)
    want = RefSim(part, torus=torus).run_min_app(sources, weights)
    port = _port_part(part)
    got = AmccaSim(port, torus=torus, device="cpu").run_min_app(sources,
                                                                weights)
    _assert_equal(want, got)
    return port, got


def _levels(part, values):
    g = values.cpu().numpy()[part.root_flat]
    return np.where(np.isfinite(g), g, -1).astype(np.int64)


@pytest.mark.parametrize("rpvo_max", [1, 4])
@pytest.mark.parametrize("torus", [False, True])
def test_sim_bfs_equals_reference(rpvo_max, torus):
    g = ref_gen.ba_skewed(120, m_per=3, seed=2)
    root = int(g.src[0])
    port, res = _sim_pair(g, RefPartitionConfig(
        num_shards=16, rpvo_max=rpvo_max, ghost_alloc="vicinity",
        local_edge_list_size=8, torus=torus, seed=1), torus, {root: 0.0},
        False)
    want = reference.bfs_levels(_port_graph(g), root)
    got = _levels(port, res.values)
    finite = want != np.iinfo(np.int32).max
    np.testing.assert_array_equal(got[finite], want[finite])
    assert (got[~finite] == -1).all()


@pytest.mark.parametrize("rpvo_max", [1, 4])
@pytest.mark.parametrize("torus", [False, True])
def test_sim_bfs_from_hub_equals_reference(rpvo_max, torus):
    """The same configs from the vertex of highest out-degree of the
    reversed graph, so BFS reaches most vertices and links contend."""
    g0 = ref_gen.ba_skewed(120, m_per=3, seed=2)
    g = RefCOOGraph(g0.n, g0.dst, g0.src, None)
    root = int(np.argmax(g.out_degrees()))
    port, res = _sim_pair(g, RefPartitionConfig(
        num_shards=16, rpvo_max=rpvo_max, ghost_alloc="vicinity",
        local_edge_list_size=8, torus=torus, seed=1), torus, {root: 0.0},
        False)
    assert res.contention_stall_cycles > 0
    want = reference.bfs_levels(_port_graph(g), root)
    finite = want != np.iinfo(np.int32).max
    np.testing.assert_array_equal(_levels(port, res.values)[finite],
                                  want[finite])


@pytest.mark.parametrize("torus", [False, True])
def test_sim_sssp_equals_reference(torus):
    g = ref_gen.erdos_renyi(100, avg_degree=4.0, seed=3
                            ).with_random_weights(seed=3)
    root = int(g.src[0])
    port, res = _sim_pair(g, RefPartitionConfig(
        num_shards=16, rpvo_max=2, local_edge_list_size=8, torus=torus,
        seed=2), torus, {root: 0.0}, True)
    want = reference.sssp_dijkstra(_port_graph(g), root)
    got = res.values.cpu().numpy()[port.root_flat]
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6)
    assert np.isinf(got[~finite]).all()


def test_sim_lazy_diffuse_prunes_equals_reference():
    """Fig 6: staged diffusions get pruned when better values arrive."""
    g = ref_gen.rmat(8, edge_factor=8, seed=5).with_random_weights(seed=5)
    root = int(g.src[0])
    _, res = _sim_pair(g, RefPartitionConfig(
        num_shards=16, rpvo_max=2, local_edge_list_size=16, seed=3), True,
        {root: 0.0}, True)
    assert res.diffusions_pruned > 0
    assert res.work_actions < res.actions_executed


def test_sim_fig6_config_equals_reference():
    """``benchmarks/fig6.py``'s simulator run: RMAT-10 SSSP on 256 CCs,
    rpvo_max 8, vicinity ghosts, from the root of highest out-degree."""
    g = ref_gen.rmat(10, edge_factor=8, seed=7).with_random_weights(seed=7)
    root = int(np.argmax(g.out_degrees()))
    port, res = _sim_pair(g, RefPartitionConfig(
        num_shards=256, rpvo_max=8, local_edge_list_size=8,
        ghost_alloc="vicinity", seed=1), True, {root: 0.0}, True)
    want = reference.sssp_dijkstra(_port_graph(g), root)
    got = res.values.cpu().numpy()[port.root_flat]
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6)
    assert res.diffusions_pruned > 0 and res.contention_stall_cycles > 0


@pytest.mark.parametrize("n,shards", [(600, 64), (1200, 256)])
def test_sim_fig10_torus_and_mesh_equal_reference(n, shards):
    """``benchmarks/fig10.py``: BFS on ba_skewed, mesh and torus."""
    g = ref_gen.ba_skewed(n, m_per=5, seed=9)
    root = int(np.argmax(g.out_degrees()))
    cycles = {}
    for torus in (False, True):
        _, res = _sim_pair(g, RefPartitionConfig(
            num_shards=shards, rpvo_max=4, local_edge_list_size=8,
            torus=torus, seed=8), torus, {root: 0.0}, False)
        cycles[torus] = res.cycles
    assert cycles[True] < cycles[False]


def test_sim_two_sources_and_no_throttle_equal_reference():
    g = ref_gen.erdos_renyi(150, avg_degree=5.0, seed=7)
    srcs = {int(g.src[0]): 0.0, int(g.src[7]): 0.0}
    part = ref_build(g, RefPartitionConfig(
        num_shards=64, rpvo_max=2, local_edge_list_size=8, seed=4))
    for throttle in (False, True):
        want = RefSim(part, torus=True).run_min_app(
            srcs, False, throttle=throttle)
        got = AmccaSim(_port_part(part), torus=True, device="cpu"
                       ).run_min_app(srcs, False, throttle=throttle)
        _assert_equal(want, got)


def _hub_graph(n=600):
    """root -> {2..n-1} -> hub: one BFS round converges on the hub."""
    root, hub = 0, 1
    others = np.arange(2, n, dtype=np.int32)
    src = np.concatenate([np.full(others.size, root, np.int32), others])
    dst = np.concatenate([others, np.full(others.size, hub, np.int32)])
    return RefCOOGraph(n, src, dst, None), root


def _cost_pair(g, trace, pcfg, torus):
    part = ref_build(g, pcfg)
    want = RefCostModel(part, torus=torus).replay(trace)
    got = CostModel(_port_part(part), torus=torus, device="cpu"
                    ).replay(trace)
    _assert_equal(want, got)
    return got


@pytest.mark.parametrize("rpvo_max", [1, 16])
@pytest.mark.parametrize("torus", [False, True])
def test_costmodel_rhizome_config_equals_reference(rpvo_max, torus):
    g, root = _hub_graph()
    trace = reference.bfs_frontier_trace(_port_graph(g), root)
    for want, got in zip(ref_oracle.bfs_frontier_trace(g, root), trace):
        np.testing.assert_array_equal(want, got)
    _cost_pair(g, trace, RefPartitionConfig(
        num_shards=64, rpvo_max=rpvo_max, local_edge_list_size=8, seed=0),
        torus)


@pytest.mark.parametrize("shards", [16, 64, 256])
def test_costmodel_strong_scaling_config_equals_reference(shards):
    g = ref_gen.rmat(12, edge_factor=8, seed=11)
    root = int(np.argmax(g.out_degrees()))
    trace = ref_oracle.bfs_frontier_trace(g, root)
    _cost_pair(g, trace, RefPartitionConfig(
        num_shards=shards, rpvo_max=8, local_edge_list_size=8, seed=6), True)


@pytest.mark.parametrize("rpvo_max", [1, 4, 16])
def test_costmodel_all_vertex_rounds_equal_reference(rpvo_max):
    """``benchmarks/fig8.py``'s PageRank-style rounds, cut to 2^12
    vertices on 1,024 CCs: every vertex diffuses each round."""
    g = ref_gen.ba_skewed(1 << 12, m_per=8, seed=3)
    trace = [np.arange(g.n, dtype=np.int64)] * 3 + [np.zeros(0, np.int64)]
    res = _cost_pair(g, trace, RefPartitionConfig(
        num_shards=1024, rpvo_max=rpvo_max, local_edge_list_size=16,
        seed=6), True)
    assert res.rounds == 3


@pytest.mark.parametrize("kind", ["min", "sum"])
def test_frontier_relax_ref_equals_reference(kind):
    rng = np.random.default_rng(5)
    values = rng.uniform(0, 10, 64).astype(np.float32)
    src = rng.integers(0, 64, 300).astype(np.int32)
    w = rng.uniform(-1, 3, 300).astype(np.float32)
    mask = rng.random(300) < 0.6
    want = np.asarray(ref_kref.frontier_relax_ref(values, src, w, mask, kind))
    got = kref.frontier_relax_ref(*map(torch.as_tensor, (values, src, w,
                                                         mask)), kind)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        kref.frontier_relax_ref(*map(torch.as_tensor, (values, src, w, mask)),
                                "max")


def test_results_stay_on_the_device():
    g = ref_gen.ba_skewed(120, m_per=3, seed=2)
    part = _port_part(ref_build(g, RefPartitionConfig(num_shards=16)))
    res = AmccaSim(part, device="cpu").run_min_app({0: 0.0}, False)
    assert isinstance(res, SimResult)
    assert res.values.dtype == torch.float64
    assert res.link_contention.shape == (16, 4)
    cres = CostModel(part, device="cpu").replay([np.array([0, 5])])
    assert isinstance(cres, CostResult)
    assert cres.link_loads.dtype == torch.int64
