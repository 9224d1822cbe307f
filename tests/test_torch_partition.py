"""The port's ``build_partition`` equals the reference's, field for field,
and ``interop`` carries a reference partition across unchanged."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import partition as ref_partition  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro.graph.graph import COOGraph as RefCOOGraph  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import partition  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.graph.graph import COOGraph  # noqa: E402


def _rand_graph(cls, n, m, seed):
    # tests/test_partition_properties.py's generator
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    return cls(n, src, dst, rng.uniform(1, 5, m).astype(np.float32))


def assert_same(a, b, where="partition"):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b or (a != a and b != b), f"{where}: {a!r} != {b!r}"


# (n, m, shards, rpvo_max, seed): the property test's ranges, corners
# included, with its local_edge_list_size=4 and seed=seed configs
RAND_CASES = [(8, 1, 2, 1, 0), (8, 40, 2, 3, 1), (50, 200, 4, 8, 2),
              (120, 500, 8, 3, 3), (120, 500, 8, 8, 4), (77, 311, 4, 1, 5),
              (33, 480, 2, 8, 2**30)]


@pytest.mark.parametrize("n,m,shards,rmax,seed", RAND_CASES)
def test_random_graph_partition_matches_reference(n, m, shards, rmax, seed):
    kw = dict(num_shards=shards, rpvo_max=rmax, local_edge_list_size=4,
              seed=seed)
    want = ref_partition.build_partition(
        _rand_graph(RefCOOGraph, n, m, seed),
        ref_partition.PartitionConfig(**kw))
    got = partition.build_partition(_rand_graph(COOGraph, n, m, seed),
                                    partition.PartitionConfig(**kw))
    assert_same(dataclasses.asdict(want), dataclasses.asdict(got))


GEN_CASES = [
    ("rmat", dict(scale=8, edge_factor=8, seed=7), dict(rpvo_max=4)),
    ("rmat", dict(scale=9, edge_factor=6, seed=1),
     dict(rpvo_max=1, ghost_alloc="home")),
    ("erdos_renyi", dict(n=150, avg_degree=4.0, seed=2),
     dict(rpvo_max=3, ghost_alloc="vicinity")),
    ("star", dict(n=64), dict(rpvo_max=8, ghost_alloc="random")),
    ("ring", dict(n=40), dict(rpvo_max=1)),
    ("ba_skewed", dict(n=200, m_per=4, seed=0),
     dict(rpvo_max=4, indegree_cutoff=8)),
]


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("gen,gkw,pkw", GEN_CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(GEN_CASES)])
def test_generator_partition_matches_reference(gen, gkw, pkw, shards):
    g_ref = getattr(ref_generators, gen)(**gkw).with_random_weights(seed=3)
    g = getattr(generators, gen)(**gkw).with_random_weights(seed=3)
    for f in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(g, f), getattr(g_ref, f))
    want = ref_partition.build_partition(
        g_ref, ref_partition.PartitionConfig(num_shards=shards, **pkw))
    got = partition.build_partition(
        g, partition.PartitionConfig(num_shards=shards, **pkw))
    assert_same(dataclasses.asdict(want), dataclasses.asdict(got))


@pytest.mark.parametrize("mesh_dims", [None, (2, 2)])
def test_interop_round_trip(mesh_dims):
    g = ref_generators.rmat(8, edge_factor=8, seed=7)
    want = ref_partition.build_partition(g, ref_partition.PartitionConfig(
        num_shards=4, rpvo_max=4, mesh_dims=mesh_dims))
    d = dataclasses.asdict(want)
    got = interop.partition_from_dict(d)
    assert isinstance(got, partition.Partition)
    assert got.cfg == partition.PartitionConfig(
        num_shards=4, rpvo_max=4, mesh_dims=mesh_dims)
    assert_same(d, dataclasses.asdict(got))
    back = ref_partition.Partition(**{
        **dataclasses.asdict(got),
        "cfg": ref_partition.PartitionConfig(
            **dataclasses.asdict(got.cfg))})
    assert_same(d, dataclasses.asdict(back))


def test_interop_rejects_foreign_dict():
    with pytest.raises(ValueError, match="fields differ"):
        interop.partition_from_dict({"n": 3})


def test_interop_tables_round_trip():
    rng = np.random.default_rng(0)
    val = rng.uniform(0, 5, (4, 9)).astype(np.float32)
    chg = rng.random((4, 9)) < 0.5
    t_val = interop.table_to_torch(val, "cpu")
    t_chg = interop.table_to_torch(chg, "cpu")
    assert t_val.dtype == torch.float32 and t_chg.dtype == torch.bool
    np.testing.assert_array_equal(interop.table_to_numpy(t_val), val)
    np.testing.assert_array_equal(interop.table_to_numpy(t_chg), chg)
