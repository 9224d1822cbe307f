"""The port's compact targeted exchange against the reference's.

The exchange primitives (``stacked_compact_partial``, ``scatter_inbox``,
``compact_collapse``, ``exchange_volume``) and the resilient runner's
helpers (``expected_round_messages``, ``mask_shard_frontier``) equal the
reference's on inputs made from a numpy seed; BFS, SSSP, PageRank and
delta-PageRank under ``exchange='compact'`` equal the reference on the
scale-8 counter-gate partition under every ``grid_mode``, with and
without the kernel path (its plain versions on the CPU, the reference's
Pallas kernels in interpret mode), under ``pallas_mode='reduce'`` and a
tiled budget: min values bit for bit, ``RunStats`` and the per-shard
message mirror exactly, sums within the reference's own tolerance
(rtol 1e-4 / atol 1e-7).  The lane runners, ``cc`` and
``personalized_pagerank`` run under compact with ``LaneStats.exchanged``
counting ``S*S*P_t`` a live lane-round.  The compact launch plan is
checked where segment blocks straddle two source shards' windows and
masked padding edges (compact id = their window's lowest) sit at each
shard's tail.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro import apps as ref_apps  # noqa: E402
from repro import exchange as ref_exchange  # noqa: E402
from repro import obs as ref_obs  # noqa: E402
from repro.apps.pagerank import _pr_graph as ref_pr_graph  # noqa: E402
from repro.core import actions as ref_actions  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro.query import lanes as ref_lanes  # noqa: E402
from repro_torch import apps, exchange, interop, obs  # noqa: E402
from repro_torch.apps.pagerank import _pr_graph  # noqa: E402
from repro_torch.core import actions, engine  # noqa: E402
from repro_torch.core.partition import PartitionConfig, build_partition  # noqa: E402,E501
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels import fused_relax_reduce as frr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.query import lanes  # noqa: E402

RTOL, ATOL = 1e-4, 1e-7
GRID_MODES = ["dense", "worklist", "auto", "device_worklist"]
SBLK, EBLK = frr.SBLK, frr.EBLK


def _gate(pr=False):
    """The scale-8 counter-gate graph (edge factor 8, seed 7) and its
    4-shard rpvo_max-4 partition in both packages, plus the root."""
    g_ref = ref_generators.rmat(8, edge_factor=8, seed=7)
    g = generators.rmat(8, edge_factor=8, seed=7)
    if pr:
        g_ref, g = ref_pr_graph(g_ref), _pr_graph(g)
    else:
        g_ref, g = (x.with_random_weights(seed=7) for x in (g_ref, g))
    part_ref = ref_partition.build_partition(
        g_ref, ref_partition.PartitionConfig(num_shards=4, rpvo_max=4))
    part = interop.partition_from_dict(dataclasses.asdict(part_ref))
    return g_ref, g, part_ref, part, int(np.argmax(g.out_degrees()))


def _cfgs(**kw):
    return ref_engine.EngineConfig(exchange="compact", **kw), \
        engine.EngineConfig(exchange="compact", **kw)


def _stats(stats):
    return [int(x) for x in stats]


def _shard_totals(rounds):
    return [sum(c) for c in zip(*(r.shard_messages for r in rounds))]


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sem_name", ["SSSP", "PAGERANK"])
@pytest.mark.parametrize("q", [None, 3])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_stacked_compact_partial_matches_reference(sem_name, q, use_pallas):
    _, _, part_ref, part, _ = _gate()
    rng = np.random.default_rng(11)
    shape = (part.S * part.R_max,) + ((q,) if q else ())
    gval = rng.uniform(0.0, 5.0, shape).astype(np.float32)
    gchg = rng.random(shape) < 0.5
    unitw = None if q is None else (np.arange(q) % 2).astype(np.int32)
    ref_cfg, cfg = _cfgs(use_pallas=use_pallas)
    want, want_n = ref_exchange.stacked_compact_partial(
        getattr(ref_actions, sem_name),
        ref_engine.DeviceArrays.from_partition(part_ref), ref_cfg, part.S,
        part.P_t, jnp.asarray(gval), jnp.asarray(gchg),
        None if unitw is None else jnp.asarray(unitw))
    arrays = engine.DeviceArrays.from_partition(part, "cpu")
    got, got_n = exchange.stacked_compact_partial(
        getattr(actions, sem_name), arrays, cfg, part.S, part.P_t,
        torch.as_tensor(gval), torch.as_tensor(gchg),
        None if unitw is None else torch.as_tensor(unitw))
    assert tuple(got.shape) == want.shape
    if sem_name == "SSSP":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def _recv_case(rng, lead, n_src, p_t, r_max, q):
    """Per-source contributions and slot maps: a (target, source) pair's
    slots are distinct, then padded with R_max."""
    slots = np.full(lead + (n_src, p_t), r_max, np.int32)
    for idx in np.ndindex(*(lead + (n_src,))):
        k = rng.integers(0, p_t + 1)
        slots[idx][:k] = rng.choice(r_max, size=k, replace=False)
    recv = rng.uniform(-3.0, 3.0, lead + (n_src, p_t)
                       + ((q,) if q else ())).astype(np.float32)
    return recv, slots


@pytest.mark.parametrize("sem_name", ["SSSP", "PAGERANK"])
@pytest.mark.parametrize("q", [None, 4])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_scatter_inbox_matches_reference(sem_name, q, lead):
    rng = np.random.default_rng(5)
    recv, slots = _recv_case(rng, lead, 5, 7, 9, q)
    ref_sem = getattr(ref_actions, sem_name)
    if lead:
        want = np.stack([np.asarray(ref_exchange.scatter_inbox(
            ref_sem, jnp.asarray(recv[t]), jnp.asarray(slots[t]), 9))
            for t in range(lead[0])])
    else:
        want = np.asarray(ref_exchange.scatter_inbox(
            ref_sem, jnp.asarray(recv), jnp.asarray(slots), 9))
    got = exchange.scatter_inbox(getattr(actions, sem_name),
                                 torch.as_tensor(recv),
                                 torch.as_tensor(slots), 9)
    # both add a slot's sources in source order from the identity
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_inbox_reads_a_source_major_stack_in_place():
    """The stacked path hands ``partial.transpose(0, 1)``: the same
    inbox as a contiguous target-major copy."""
    rng = np.random.default_rng(2)
    recv, slots = _recv_case(rng, (4,), 4, 6, 11, 3)
    src_major = torch.as_tensor(recv).transpose(0, 1).contiguous()
    for sem in (actions.SSSP, actions.PAGERANK):
        want = exchange.scatter_inbox(sem, torch.as_tensor(recv),
                                      torch.as_tensor(slots), 11)
        got = exchange.scatter_inbox(sem, src_major.transpose(0, 1),
                                     torch.as_tensor(slots), 11)
        assert torch.equal(got, want)


@pytest.mark.parametrize("sem_name", ["SSSP", "PAGERANK"])
@pytest.mark.parametrize("q", [None, 3])
def test_compact_collapse_matches_reference(sem_name, q):
    _, _, part_ref, part, _ = _gate()
    rng = np.random.default_rng(3)
    shape = (part.S, part.R_max) + ((q,) if q else ())
    cand = rng.uniform(0.0, 4.0, shape).astype(np.float32)
    cand[rng.random(shape) < 0.3] = np.inf if sem_name == "SSSP" else 0.0
    ref_arr = ref_engine.DeviceArrays.from_partition(part_ref)
    want = ref_exchange.compact_collapse(
        getattr(ref_actions, sem_name), jnp.asarray(cand),
        ref_arr.rz_local, ref_arr.rz_sibling_idx, ref_arr.rz_sibling_mask,
        lambda x: x.reshape((-1,) + x.shape[2:]), part.R_max, part.R_rz_max)
    arrays = engine.DeviceArrays.from_partition(part, "cpu")
    got = exchange.compact_collapse(
        getattr(actions, sem_name), torch.as_tensor(cand), arrays.rz_local,
        arrays.rz_sibling_idx, arrays.rz_sibling_mask,
        lambda x: x.reshape((-1,) + tuple(x.shape[2:])), part.R_max,
        part.R_rz_max)
    if sem_name == "SSSP":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_exchange_volume_matches_reference():
    for exch in ("dense", "compact"):
        for S, R_max, P_t in ((4, 97, 73), (16, 16682, 8777), (1, 5, 5)):
            assert exchange.exchange_volume(
                S, R_max, P_t, engine.EngineConfig(exchange=exch)) \
                == ref_exchange.exchange_volume(
                    S, R_max, P_t, ref_engine.EngineConfig(exchange=exch))


@pytest.mark.parametrize("laned", [False, True])
def test_round_helpers_match_reference(laned):
    """``expected_round_messages`` and ``mask_shard_frontier`` (the
    resilient runner's inbox-integrity check and dropped-inbox
    injector), on numpy and on tensors; ``axis_tuple``."""
    _, _, part_ref, part, _ = _gate()
    rng = np.random.default_rng(9)
    shape = (part.S, part.R_max) + ((3,) if laned else ())
    chg = rng.random(shape) < 0.4
    gchg = chg.reshape((-1,) + shape[2:])
    assert exchange.expected_round_messages(
        part.edge_mask, part.edge_src_root_flat, gchg, laned=laned) \
        == ref_exchange.expected_round_messages(
            part_ref.edge_mask, part_ref.edge_src_root_flat, gchg,
            laned=laned)
    for shard in range(part.S):
        want = np.asarray(ref_exchange.mask_shard_frontier(
            jnp.asarray(chg), shard))
        np.testing.assert_array_equal(
            exchange.mask_shard_frontier(chg, shard), want)
        t = torch.as_tensor(chg)
        got = exchange.mask_shard_frontier(t, shard)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(t, torch.as_tensor(chg))   # a new table
        np.testing.assert_array_equal(
            exchange.rounds._mask_np(chg, shard),
            ref_exchange.rounds._mask_np(chg, shard))
    for names in ("data", ("data", "model")):
        assert exchange.axis_tuple(names) == ref_exchange.axis_tuple(names)


# --------------------------------------------------------------------------
# the compact launch plan
# --------------------------------------------------------------------------

def _plan_part(name):
    if name == "gate":
        return _gate()[3]
    g = generators.rmat(9, edge_factor=6, seed=1).with_random_weights(seed=1)
    return build_partition(g, PartitionConfig(num_shards=8, rpvo_max=4))


@pytest.mark.parametrize("graph", ["gate", "rmat9_8shards"])
def test_compact_plan_straddling_blocks_and_masked_tails(graph):
    """The plan over the offset compact ids: S*P_t is not a multiple of
    SBLK, so blocks straddle two source shards' windows, and each shard's
    masked padding edges carry its window's lowest id.  The planned cells
    are exactly the (block, chunk) pairs whose VALID id range meets the
    block (the padding never widens a chunk's range), the host planner
    mirrors them, its flag bytes equal ``worklist_flags`` of its cells,
    and each cell's batch range covers exactly its valid edges."""
    part = _plan_part(graph)
    S, P_t, R_max = part.S, part.P_t, part.R_max
    win = S * P_t
    assert win % SBLK, "the windows must not align with segment blocks"
    arrays = engine.DeviceArrays.from_partition(part, "cpu")
    plan = arrays.compact.plan
    ids = arrays.compact.ids.numpy().astype(np.int64)
    mask = part.edge_mask.reshape(-1)
    assert plan.num_segments == S * win and plan.num_slots == S * R_max
    # the masked tails: padding edges sit at each shard's end, their ids
    # are their window's start, and the valid ids are sorted per shard
    per = ids.reshape(S, -1)
    assert (~part.edge_mask).any()
    for s in range(S):
        m = part.edge_mask[s]
        assert not m[m.sum():].any()
        assert (per[s][~m] == s * win).all()
        assert (np.diff(per[s][m]) >= 0).all()
        assert per[s][m].min() >= s * win and per[s][m].max() < (s + 1) * win
    # blocks that straddle two windows exist and are planned
    straddle = [i for i in range(plan.num_blocks)
                if (i * SBLK) // win != min((i + 1) * SBLK - 1,
                                            S * win - 1) // win]
    assert straddle
    # planned cells == brute force over the valid edges
    n_chunks = -(-ids.size // EBLK)
    want = set()
    for j in range(n_chunks):
        sl = slice(j * EBLK, (j + 1) * EBLK)
        v = ids[sl][mask[sl]]
        if v.size:
            want |= {(i, j) for i in range(v.min() // SBLK,
                                          v.max() // SBLK + 1)}
    got = set(zip(plan.cell_i.tolist(), plan.cell_j.tolist()))
    assert got == want
    assert any(i in straddle for i, _ in got)
    # the host planner mirrors it; its flags list its cells on the plan
    planner = engine.launch_planner(part, engine.EngineConfig(
        exchange="compact", use_pallas=True, grid_mode="worklist"))
    assert planner.launch_cells == plan.num_cells
    rng = np.random.default_rng(1)
    gchg = rng.random(S * R_max) < 0.2
    wl, _ = planner.plan(gchg)
    np.testing.assert_array_equal(
        wl.flags.numpy(),
        frr.worklist_flags(plan, wl.wl_i, wl.wl_j, wl.nlive).numpy())
    assert frr.device_worklist_pad(plan) >= plan.num_cells
    # the pieces cut each block's cells in order, a block with no cell is
    # one empty piece, and a split block's pieces take consecutive rows of
    # the split buffer
    pc = frr.plan_pieces(plan)
    ptr, blk = pc.piece_ptr.numpy(), pc.piece_blk.numpy()
    slot, bp = pc.piece_slot.numpy(), pc.blk_piece.numpy()
    real = blk >= 0
    assert real.sum() == bp[-1] and not real[bp[-1]:].any()
    rows = []
    for i in range(plan.num_blocks):
        ks = np.arange(bp[i], bp[i + 1])
        assert (blk[ks] == i).all()
        lo, hi = plan.blk_ptr[i].item(), plan.blk_ptr[i + 1].item()
        assert ptr[ks[0]] == lo and ptr[ks[-1] + 1] == hi
        assert (np.diff(ptr[ks[0]:ks[-1] + 2]) <= frr.PIECE_CELLS).all()
        rows += slot[ks].tolist() if ks.size > 1 else []
        assert ks.size > 1 or slot[ks[0]] == -1
    assert rows == list(range(len(rows))) and len(rows) <= pc.n_split
    # batch ranges: each cell's [first, last) 32-edge batches hold all of
    # its block's valid edges in its chunk and start/end on one of them
    bat = frr.plan_batches(plan, arrays.compact.ids).numpy().astype(int)
    blk_of_cell = np.repeat(np.arange(plan.num_blocks),
                            np.diff(plan.blk_ptr.numpy()))
    for p, (i, j) in enumerate(zip(blk_of_cell, plan.blk_chunk.tolist())):
        sl = slice(j * EBLK, (j + 1) * EBLK)
        pos = np.flatnonzero(mask[sl] & (ids[sl] // SBLK == i))
        lo, hi = bat[p]
        assert pos.size and lo == pos[0] // 32 and hi == pos[-1] // 32 + 1


def test_compact_tables_are_built_on_first_use():
    """A dense run never uploads the compact tables or builds their
    plan: ``DeviceArrays.compact`` makes them on first use."""
    _, g, _, part, root = _gate()
    arrays = engine.DeviceArrays.from_partition(part, "cpu")
    assert "plan" not in vars(arrays.compact)
    assert "edge_dst_compact" not in vars(arrays.compact)
    assert arrays.launch_plan(engine.EngineConfig()) is arrays.fused_plan
    plan = arrays.launch_plan(engine.EngineConfig(exchange="compact"))
    assert plan is arrays.compact.plan and "plan" in vars(arrays.compact)
    np.testing.assert_array_equal(arrays.edge_dst_compact.numpy(),
                                  part.edge_dst_compact)
    np.testing.assert_array_equal(arrays.inbox_slot_map.numpy(),
                                  part.inbox_slot_map)
    assert arrays.rz_sibling_mask.dtype == torch.bool


# --------------------------------------------------------------------------
# the apps under compact
# --------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["bfs", "sssp"])
@pytest.mark.parametrize("grid_mode", GRID_MODES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_min_apps_match_reference(app, grid_mode, use_pallas):
    g_ref, g, part_ref, part, root = _gate()
    ref_cfg, cfg = _cfgs(use_pallas=use_pallas, grid_mode=grid_mode)
    with ref_obs.recording() as ref_rec:
        want, ws, _ = getattr(ref_apps, app)(g_ref, root, part=part_ref,
                                             cfg=ref_cfg)
    with obs.recording() as rec:
        got, gs, _ = getattr(apps, app)(g, root, part=part, cfg=cfg,
                                        device="cpu")
    np.testing.assert_array_equal(got, want)
    assert _stats(gs) == _stats(ws)
    assert _shard_totals(rec.rounds) == _shard_totals(ref_rec.rounds)
    # the same counters as the dense exchange
    _, ds, _ = getattr(apps, app)(g, root, part=part, device="cpu",
                                  cfg=engine.EngineConfig(
                                      use_pallas=use_pallas,
                                      grid_mode=grid_mode))
    assert _stats(gs) == _stats(ds)


@pytest.mark.parametrize("grid_mode", GRID_MODES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_pagerank_delta_matches_reference(grid_mode, use_pallas):
    g_ref, g, part_ref, part, _ = _gate(pr=True)
    ref_cfg, cfg = _cfgs(use_pallas=use_pallas, grid_mode=grid_mode)
    with ref_obs.recording() as ref_rec:
        want, ws, _ = ref_apps.pagerank_delta(g_ref, part=part_ref,
                                              cfg=ref_cfg)
    with obs.recording() as rec:
        got, gs, _ = apps.pagerank_delta(g, part=part, cfg=cfg,
                                         device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _stats(gs) == _stats(ws)
    assert _shard_totals(rec.rounds) == _shard_totals(ref_rec.rounds)


@pytest.mark.parametrize("kw", [
    dict(use_pallas=p, grid_mode=m) for p in (False, True)
    for m in GRID_MODES] + [dict(use_pallas=True, pallas_mode="reduce")],
    ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_pagerank_matches_reference(kw):
    g_ref, g, part_ref, part, _ = _gate(pr=True)
    ref_cfg, cfg = _cfgs(**kw)
    want, _ = ref_apps.pagerank(g_ref, part=part_ref, cfg=ref_cfg)
    got, _ = apps.pagerank(g, part=part, cfg=cfg, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("app", ["bfs", "sssp"])
@pytest.mark.parametrize("kw", [dict(pallas_mode="reduce"),
                                dict(vmem_budget_bytes=512),
                                dict(vmem_budget_bytes=512,
                                     grid_mode="worklist"),
                                dict(vmem_budget_bytes=512,
                                     grid_mode="device_worklist")],
                         ids=["reduce", "tiled", "tiled_worklist",
                              "tiled_device_worklist"])
def test_reduce_and_tiled_match_reference(app, kw):
    """K9's plan under ``pallas_mode='reduce'`` and the tiled plans (K5,
    K6) under a budget below the table, both on the compact ids."""
    g_ref, g, part_ref, part, root = _gate()
    ref_cfg, cfg = _cfgs(use_pallas=True, **kw)
    with ref_obs.recording() as ref_rec:
        want, ws, _ = getattr(ref_apps, app)(g_ref, root, part=part_ref,
                                             cfg=ref_cfg)
    with obs.recording() as rec:
        got, gs, _ = getattr(apps, app)(g, root, part=part, cfg=cfg,
                                        device="cpu")
    np.testing.assert_array_equal(got, want)
    assert _stats(gs) == _stats(ws)
    assert _shard_totals(rec.rounds) == _shard_totals(ref_rec.rounds)
    if "vmem_budget_bytes" in kw:
        assert {r.path for r in rec.rounds} == {"tiled"}


def test_kernel_plain_versions_on_the_compact_plan():
    """K1, K2 (a device plan), K3 and K9 wrappers on the compact plan
    (their plain versions on the CPU) equal the reference's per-source
    partials."""
    g_ref, g, part_ref, part, root = _gate()
    arrays = engine.DeviceArrays.from_partition(part, "cpu")
    plan, ids = arrays.compact.plan, arrays.compact.ids
    n = part.S * part.S * part.P_t
    rng = np.random.default_rng(4)
    gval = torch.as_tensor(rng.uniform(0, 3, part.S * part.R_max)
                           .astype(np.float32))
    gchg = torch.as_tensor(rng.random(part.S * part.R_max) < 0.3)
    src = arrays.edge_src_root_flat.reshape(-1)
    w = arrays.edge_w.reshape(-1)
    mask = arrays.edge_mask.reshape(-1)
    want = ref.fused_relax_reduce_ref(gval, gchg, src, w, mask, ids, n,
                                      "add_w", "min")
    for gm in ("dense", "device_worklist"):
        out, _ = frr.fused_relax_reduce(gval, gchg, src, w, mask, ids, n,
                                        "add_w", "min", with_count=True,
                                        plan=plan, grid_mode=gm)
        assert torch.equal(out, want)
    q = 3
    gv = gval[:, None].repeat(1, q)
    gc = gchg[:, None].repeat(1, q)
    out = frr.fused_relax_reduce_lanes(gv, gc, torch.zeros(q), src, w, mask,
                                       ids, n, "add_w", "min", plan=plan)
    assert torch.equal(out, want[:, None].repeat(1, q))
    msg = torch.where(mask & gchg[src.long()], gval[src.long()] + w,
                      torch.inf)
    from repro_torch.kernels import rhizome_segment_reduce as rsr
    out = rsr.segment_combine(msg, ids, n, "min", plan=plan)
    assert torch.equal(out, want)


# --------------------------------------------------------------------------
# lanes under compact
# --------------------------------------------------------------------------

def _lane_stats(stats):
    return {f: np.asarray(getattr(stats, f)).astype(np.int64).tolist()
            for f in stats._fields}


@pytest.mark.parametrize("grid_mode", GRID_MODES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_lanes_match_reference(grid_mode, use_pallas):
    g_ref, g, part_ref, part, root = _gate()
    deg = np.argsort(-g.out_degrees())
    queries = [("bfs", int(deg[0])), ("sssp", int(deg[1])),
               ("bfs", [int(deg[2]), int(deg[3])]), ("sssp", int(deg[4]))]
    ref_cfg, cfg = _cfgs(use_pallas=use_pallas, grid_mode=grid_mode)
    want, ws, _ = ref_apps.batched_queries(g_ref, queries, part=part_ref,
                                           cfg=ref_cfg)
    got, gs, _ = apps.batched_queries(g, queries, part=part, cfg=cfg,
                                      device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _lane_stats(gs) == _lane_stats(ws)
    vol = part.S * part.S * part.P_t
    np.testing.assert_array_equal(gs.exchanged.numpy(),
                                  gs.rounds.numpy() * vol)
    # the same lanes and counters as the dense exchange, fewer exchanged
    dense, ds, _ = apps.batched_queries(g, queries, part=part, device="cpu",
                                        cfg=engine.EngineConfig(
                                            use_pallas=use_pallas,
                                            grid_mode=grid_mode))
    for a, b in zip(got, dense):
        np.testing.assert_array_equal(a, b)
    assert gs.rounds.tolist() == ds.rounds.tolist()
    assert gs.messages.tolist() == ds.messages.tolist()
    assert (gs.exchanged < ds.exchanged).all()


@pytest.mark.parametrize("grid_mode", ["dense", "worklist",
                                       "device_worklist"])
def test_tiled_lanes_match_reference(grid_mode):
    """The tiled lane plans (K7 dense, K8 worklist: their plain versions)
    on the compact ids under a budget below the (S*R_max, Q) table."""
    g_ref, g, part_ref, part, root = _gate()
    deg = np.argsort(-g.out_degrees())
    queries = [("bfs", int(deg[0])), ("sssp", int(deg[1]))]
    ref_cfg, cfg = _cfgs(use_pallas=True, grid_mode=grid_mode,
                         vmem_budget_bytes=1024)
    want, ws, _ = ref_apps.batched_queries(g_ref, queries, part=part_ref,
                                           cfg=ref_cfg)
    assert frr.select_kernel_path(part.S * part.R_max, len(queries),
                                  1024)[0] == "tiled"
    got, gs, _ = apps.batched_queries(g, queries, part=part, cfg=cfg,
                                      device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _lane_stats(gs) == _lane_stats(ws)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_lane_budget_under_compact_matches_reference(use_pallas):
    _, _, part_ref, part, root = _gate()
    init, unitw = lanes.init_lane_values(part, [("bfs", root),
                                                ("sssp", root)])
    ref_cfg, cfg = _cfgs(use_pallas=use_pallas)
    wv, ws = ref_lanes.run_stacked_lanes(part_ref, init, unitw, ref_cfg,
                                         lane_budget=[2, 100])
    gv, gs = lanes.run_stacked_lanes(part, init, unitw, cfg,
                                     lane_budget=[2, 100], device="cpu")
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert _lane_stats(gs) == _lane_stats(ws)


@pytest.mark.parametrize("grid_mode", ["dense", "device_worklist"])
def test_ppr_lanes_match_reference(grid_mode):
    g_ref, g, part_ref, part, _ = _gate(pr=True)
    deg = np.argsort(-g.out_degrees())
    seeds = [int(deg[0]), int(deg[3])]
    ref_cfg, cfg = _cfgs(use_pallas=True, grid_mode=grid_mode)
    want, ws, _ = ref_apps.personalized_pagerank(
        g_ref, seeds, [0.85, 0.6], part=part_ref, cfg=ref_cfg, tol=1e-6)
    got, gs, _ = apps.personalized_pagerank(
        g, seeds, [0.85, 0.6], part=part, cfg=cfg, tol=1e-6, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert gs.rounds.tolist() == np.asarray(ws.rounds).tolist()
    assert gs.exchanged.tolist() == np.asarray(ws.exchanged).tolist()
    wv, wds = ref_lanes.run_ppr_delta_lanes(part_ref, seeds, [0.85, 0.6],
                                            ref_cfg, tol=1e-7)
    gv, gds = lanes.run_ppr_delta_lanes(part, seeds, [0.85, 0.6], cfg,
                                        tol=1e-7, device="cpu")
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL,
                               atol=ATOL)
    assert _lane_stats(gds) == _lane_stats(wds)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cc_matches_reference(use_pallas):
    g_ref = ref_generators.rmat(8, edge_factor=2, seed=3)
    g = generators.rmat(8, edge_factor=2, seed=3)
    ref_cfg, cfg = _cfgs(use_pallas=use_pallas)
    want, ws, _ = ref_apps.cc(g_ref, cfg=ref_cfg, num_shards=4, rpvo_max=2)
    got, gs, part = apps.cc(g, cfg=cfg, num_shards=4, rpvo_max=2,
                            device="cpu")
    np.testing.assert_array_equal(got, want)
    assert _lane_stats(gs) == _lane_stats(ws)
    assert gs.exchanged.tolist() == [int(gs.rounds[0])
                                     * part.S * part.S * part.P_t]
