"""The port's dry run (``repro_torch.lm.launch.dryrun`` / ``reanalyze``)
on fake process groups and fake CPU tensors, against the reference's
compiled per-device HLO where both have the figure: per-rank counting of
a sharded product, the graph cell's per-round collective bytes, reduced
LM cells' product FLOPs and collective kinds, reduced cells' records
and their reanalysis, the pipeline cell, and the MoE expert counts
under ``FakeTensorMode``.

Every fake group is made and torn down inside the call or test that
needs it (no default group outlives a test); the reference compiles its
cells in one child process with 8 host devices.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.lm.launch import dryrun, reanalyze
from repro_torch.lm.launch.mesh import make_test_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# the reference's record keys (``repro.lm.launch.dryrun.run_cell``)
REF_KEYS = {"arch", "shape", "multi_pod", "rules", "opts", "lower_s",
            "compile_s", "memory", "xla_cost_raw", "num_devices",
            "per_device", "collectives", "roofline", "model_flops",
            "useful_compute_ratio", "ok"}
REF_MEMORY = {"argument_size_bytes", "output_size_bytes", "temp_size_bytes",
              "generated_code_size_bytes"}
REF_PER_DEVICE = {"flops", "bytes_accessed", "collective_bytes",
                  "collective_total", "has_dynamic_loops", "num_whiles"}
REF_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
                "bound_s"}


@pytest.fixture(autouse=True)
def _one_thread_no_group():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    yield
    torch.set_num_threads(threads)
    assert not dist.is_initialized()


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    return tmp_path


def test_sharded_product_counts_one_rank():
    """A (256, 4096) Shard(0) @ (4096, 1024) Shard(1) product on a fake
    (2, 2) mesh: the rank's FLOPs are the global count / 4 exactly (no
    sharding-propagation rerun of the global op is counted) and its
    collectives are the result's all-gathers."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    with dryrun.fake_group(4):
        mesh = make_test_mesh((2, 2), device="cpu")
        with dryrun.fake_tensors():
            a = distribute_tensor(torch.empty(256, 4096), mesh,
                                  (Shard(0), Replicate()), src_data_rank=None)
            b = distribute_tensor(torch.empty(4096, 1024), mesh,
                                  (Replicate(), Shard(1)), src_data_rank=None)
            with FlopCounterMode(display=False) as fc:
                a @ b
            low = dryrun.Lowered(
                lambda: (a @ b).redistribute(mesh, (Replicate(),) * 2), [a, b])
            rec = dryrun.record_trace({}, low, 4)
    pd = rec["per_device"]
    assert fc.get_total_flops() == 2 * 256 * 4096 * 1024
    assert pd["flops"] == fc.get_total_flops() / 4
    assert pd["collective_bytes"] == {"all-gather": (128 * 1024 + 256 * 1024)
                                      * 4.0}
    assert rec["memory"]["argument_size_bytes"] == (128 * 4096
                                                    + 4096 * 512) * 4


CHILD = textwrap.dedent("""
    import dataclasses, os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import actions
    from repro.core.engine import DeviceArrays, EngineConfig, make_sharded_fn
    from repro.lm.launch import hlo_analysis

    # the backend starts with 8 devices before the reference's dryrun
    # module puts its 512 in front of XLA_FLAGS
    assert len(jax.devices()) == 8
    from repro.lm.launch import dryrun
    from repro.lm.launch.mesh import make_test_mesh

    arg = json.loads(sys.argv[1])
    d = arg["graph"]
    S, R_max, E_max, K = 8, d["R_max"], d["E_max"], d["K"]
    P_t, R_rz = d["P_t"], d["R_rz"]
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    out = {}
    for compact in (False, True):
        fn, sharding = make_sharded_fn(
            actions.BFS, S, R_max, mesh, ("data", "model"),
            EngineConfig(exchange="compact" if compact else "dense"))
        sds = lambda s, t: jax.ShapeDtypeStruct(s, t, sharding=sharding)
        arrays = DeviceArrays(
            edge_src_root_flat=sds((S, E_max), jnp.int32),
            edge_dst_flat=sds((S, E_max), jnp.int32),
            edge_w=sds((S, E_max), jnp.float32),
            edge_mask=sds((S, E_max), jnp.bool_),
            sibling_flat=sds((S, R_max, K), jnp.int32),
            sibling_mask=sds((S, R_max, K), jnp.bool_),
            slot_valid=sds((S, R_max), jnp.bool_),
            edge_dst_compact=sds((S, E_max), jnp.int32),
            inbox_slot_map=sds((S, S, P_t), jnp.int32),
            rz_local=sds((S, R_rz), jnp.int32),
            rz_sibling_idx=sds((S, R_rz, K), jnp.int32),
            rz_sibling_mask=sds((S, R_rz, K), jnp.bool_))
        hlo = fn.lower(arrays, sds((S, R_max), jnp.float32)).compile() \\
            .as_text()
        ana = hlo_analysis.analyze(hlo)
        out["compact" if compact else "dense"] = {
            "collective_bytes": ana.collective_bytes,
            "has_dynamic_loops": ana.has_dynamic_loops}

    # the reference's own _lower_cell on a reduced config and a (2, 2) mesh
    dryrun.make_production_mesh = lambda multi_pod=False: make_test_mesh()
    full_config = dryrun.get_config
    for arch, shape, remat in arg["lm"]:
        dryrun.get_config = lambda a: dataclasses.replace(
            full_config(a).reduced(), remat=remat)
        lowered, _ = dryrun._lower_cell(arch, shape, False)
        ana = hlo_analysis.analyze(lowered.compile().as_text())
        out[f"{arch}/{shape}/{remat}"] = {
            "flops": ana.flops, "collective_bytes": ana.collective_bytes}
    print("REF_JSON" + json.dumps(out))
""")

# (arch, shape, remat): remat as 15b's full-size step has it
LM_CELLS = [("minitron-4b", "train_4k", False), ("minitron-4b", "train_4k", True),
            ("granite-moe-1b-a400m", "decode_32k", False)]


@pytest.fixture(scope="module")
def reference():
    """The reference's compiled per-device figures, from one child with
    8 host devices: the graph cell's ``make_sharded_fn`` at RMAT-10 on a
    (4, 2) mesh (dense and compact), and ``LM_CELLS`` lowered by the
    reference's ``_lower_cell`` at their reduced configs on a (2, 2)
    mesh, each read by the reference's ``hlo_analysis.analyze``."""
    arg = {"graph": dryrun.graph_cell_shapes(8, n_log2=10), "lm": LM_CELLS}
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", CHILD, json.dumps(arg)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(next(s for s in res.stdout.splitlines()
                           if s.startswith("REF_JSON"))[len("REF_JSON"):])


def test_graph_round_bytes_equal_reference_hlo(reference):
    """One traced round of the graph cell (RMAT-10 analytic shapes, 8
    ranks as a (4, 2) mesh) moves the all-gather and all-to-all bytes of
    the reference's compiled ``make_sharded_fn`` while loop (body and
    condition counted once), dense and compact.  The all-reduce differs
    by design: the reference reduces three int32 scalars (messages and
    work in the body, the live count in the condition: 12 bytes), the
    port one int64 [messages, work, any-changed] vector (24 bytes)."""
    ref = reference
    for name, compact in (("dense", False), ("compact", True)):
        with dryrun.fake_group(8):
            mesh = make_test_mesh((4, 2), device="cpu")
            with dryrun.fake_tensors():
                low, _ = dryrun.lower_graph_cell(False, n_log2=10,
                                                 compact=compact, mesh=mesh)
                rec = dryrun.record_trace({}, low, 8)
        got = rec["per_device"]["collective_bytes"]
        want = ref[name]["collective_bytes"]
        assert ref[name]["has_dynamic_loops"]
        assert rec["per_device"]["has_dynamic_loops"]
        for kind in ("all-gather", "all-to-all"):
            assert got[kind] == want[kind], (name, kind, got, want)
        assert (got["all-reduce"], want["all-reduce"]) == (24.0, 12.0)


def _moe_halved(cfg, shape):
    """Per-rank FLOPs of the reference's MoE router and expert products
    on a (2, 2) mesh that the port does not do, all layers: XLA's
    partitioner all-gathers the router and the expert weights over
    ``data`` (where they are FSDP'd on d) and every data rank computes
    them whole; ``DTensor`` keeps each weight's d shard and contracts it
    locally into partial sums (reduce-scattered or all-reduced), so each
    rank does half of those products."""
    m = cfg.moe
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    cap = max(int(tokens * m.top_k / m.num_experts * m.capacity_factor), 1)
    router = 2 * (tokens // 2) * cfg.d_model * m.num_experts
    experts = 3 * 2 * (m.num_experts // 2) * cap * cfg.d_model * m.d_expert_ff
    return cfg.n_layers * (router + experts) / 2


# collective kinds that one package's per-device program has and the
# other's has not, by design: XLA reshards between layouts by all-to-all
# (minitron: the attention's sequence- and head-sharded layouts;
# granite's decode: around the router product) and moves a gather's
# operand by collective-permute, where the port gathers the whole
# operand (all-gather); DTensor turns a partial sum into a shard by
# reduce-scatter, where XLA all-reduces it and slices
KINDS_ONLY_REFERENCE = {"minitron-4b": {"all-to-all"},
                        "granite-moe-1b-a400m": {"all-to-all",
                                                 "collective-permute"}}
KINDS_ONLY_PORT = {"reduce-scatter"}


@pytest.mark.parametrize("arch,shape,remat", LM_CELLS)
def test_reduced_cell_products_and_collectives_equal_reference(
        reference, arch, shape, remat):
    """A reduced LM cell on a fake (2, 2) mesh against the reference's
    per-device HLO for the same config and mesh: the product FLOPs
    (recomputed forwards under remat included) equal the reference's dot
    FLOPs exactly (no fusion changes a dot), less the MoE products the
    reference repeats on every data rank (``_moe_halved``: granite
    only); the collective kinds are the reference's, but for the kinds
    each partitioner uses in place of the other's (``KINDS_ONLY_*``).
    A MoE train cell is not held: its backward's partitions differ
    further, with no closed form (granite, remat: the port's 2.3676e12
    against the reference's 2.4060e12)."""
    from repro_torch.lm.configs import SHAPES, get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    with dryrun.fake_group(4):
        mesh = make_test_mesh((2, 2), device="cpu")
        with dryrun.fake_tensors():
            rec = dryrun.record_trace(
                {}, dryrun.lower_model(cfg, SHAPES[shape], mesh), 4)
    want = reference[f"{arch}/{shape}/{remat}"]
    moe = _moe_halved(cfg, SHAPES[shape]) if cfg.moe is not None else 0.0
    assert rec["per_device"]["flops"] == want["flops"] - moe
    got_kinds = set(rec["per_device"]["collective_bytes"])
    want_kinds = set(want["collective_bytes"])
    assert want_kinds - got_kinds == KINDS_ONLY_REFERENCE[arch]
    assert got_kinds - want_kinds == KINDS_ONLY_PORT


def _check_record(rec):
    assert rec["ok"], rec.get("traceback")
    assert REF_KEYS <= set(rec), sorted(REF_KEYS - set(rec))
    assert set(rec["memory"]) == REF_MEMORY
    assert set(rec["per_device"]) == REF_PER_DEVICE
    assert REF_ROOFLINE <= set(rec["roofline"])
    pd = rec["per_device"]
    assert pd["flops"] > 0 and pd["bytes_accessed"] > 0
    assert pd["num_whiles"] is None and rec["compile_s"] is None
    for field in ("compile_s", "xla_cost_raw", "per_device.num_whiles",
                  "memory.generated_code_size_bytes"):
        assert rec["null_reasons"][field]
    assert rec["memory"]["temp_size_bytes"] > 0
    assert rec["roofline"]["bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s", "collective_s"))
    assert 0 < rec["useful_compute_ratio"] <= 1.0
    assert rec["trace_s"] >= 0 and rec["num_devices"] == 4


@pytest.mark.parametrize("arch,shape", [("minitron-4b", "train_4k"),
                                        ("granite-moe-1b-a400m",
                                         "decode_32k")])
def test_reduced_cell_records_every_reference_key(results, arch, shape):
    """A reduced cell (the smoke-scale config on the fake (2, 2) mesh)
    records every key the reference's ``run_cell`` writes, caches its
    record, and ``reanalyze`` reproduces it field for field from the
    trace summary."""
    rec = dryrun.run_cell(arch, shape, False, device="cpu", reduced=True)
    _check_record(rec)
    tag = f"{arch}__{shape}__pod1__default__reduced"
    path = results / f"{tag}.json"
    assert json.loads(path.read_text()) == rec
    assert dryrun.run_cell(arch, shape, False, device="cpu",
                           reduced=True) == rec      # cached
    again = reanalyze.reanalyze(rec, str(results / f"{tag}.trace.json.gz"))
    assert again == rec
    reanalyze.main(str(results))
    assert json.loads(path.read_text()) == rec


def test_cell_applicable_skips_as_the_reference(results):
    rec = dryrun.run_cell("minitron-4b", "long_500k", False, device="cpu",
                          reduced=True)
    assert "skipped" in rec and "ok" not in rec


def test_pipeline_cell_sends_and_receives(results):
    """The 2-stage GPipe cell as rank 0 (stage 0): 9 ticks of 4 MLP
    layers (two products each), 9 sends of one microbatch and the last
    stage's 8 outputs received: the reference's collective-permute
    bytes."""
    rec = dryrun.run_cell(*dryrun.PIPELINE_CELL, True, device="cpu")
    assert rec["ok"], rec.get("traceback")
    # the reference's file name for it
    assert json.loads((results / "pipeline-gpipe2.json").read_text()) == rec
    mb = 32 * 4096 * 2
    assert rec["per_device"]["collective_bytes"] == {
        "collective-permute": float(9 * mb + 8 * mb)}
    assert rec["per_device"]["flops"] == 9 * 4 * 2 * (2 * 32 * 4096 * 16384)


def test_trace_budget_fails_the_cell(results):
    rec = dryrun.run_cell("minitron-4b", "train_4k", False, device="cpu",
                          reduced=True, budget_s=1e-9, force=True)
    assert not rec["ok"] and rec["error"].startswith("TimeoutError")


def test_moe_counts_run_on_fake_tensors_and_equal_bincount():
    """The MoE layer's expert counts (a ``scatter_add_`` of ones) run
    under ``FakeTensorMode`` (``bincount``'s output shape depends on the
    ids, which a fake tensor refuses), and equal ``torch.bincount`` on
    real tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.lm.configs import get_config
    from repro_torch.lm.models import Model
    from repro_torch.lm.models.moe import expert_counts
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 32, 4096))
    got = expert_counts(ids, 32)
    assert got.dtype == torch.bincount(ids).dtype
    assert torch.equal(got, torch.bincount(ids, minlength=32))
    cfg = get_config("granite-moe-1b-a400m").reduced()
    with FakeTensorMode():
        model = Model(cfg, device="cpu")
        tokens = torch.zeros((2, 16), dtype=torch.int64)
        loss, metrics = model.loss(model.param_tree(), {"tokens": tokens})
    assert loss.shape == () and "moe_load_balance" in metrics


def test_entry_points_name_their_device(results):
    """``--device cpu`` runs; the CLI prints the cell's line."""
    dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k",
                 "--reduced", "--device", "cpu"])
    rec = json.loads((results / "xlstm-125m__long_500k__pod1__default__"
                                "reduced.json").read_text())
    assert rec["ok"] and rec["device"] == "cpu"


def test_traced_step_counts_equal_the_real_step():
    """A reduced minitron step (bfloat16, remat) traced on a fake (1, 1)
    mesh counts the FLOPs ``FlopCounterMode`` counts over the same step
    run for real on CPU tensors without a mesh, and its argument bytes
    are the real step's parameter, moment, step and batch bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.lm.configs import get_config
    from repro_torch.lm.configs.base import ShapeSpec
    from repro_torch.lm.models import Model
    from repro_torch.lm.train.optimizer import AdamW, _leaves, cosine_schedule
    from repro_torch.lm.train.train_step import TrainState, make_train_step
    cfg = dataclasses.replace(get_config("minitron-4b").reduced(),
                              dtype="bfloat16", param_dtype="bfloat16",
                              remat=True)
    shape = ShapeSpec("t", "train", 64, 4)
    with dryrun.fake_group(1):
        mesh = make_test_mesh((1, 1), device="cpu")
        with dryrun.fake_tensors():
            rec = dryrun.record_trace({}, dryrun.lower_model(cfg, shape, mesh),
                                      1)
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10000))
    params = model.param_tree()
    state = TrainState(params, opt.init(params), None)
    batch = {k: torch.randint(0, cfg.vocab, (4, 64), dtype=torch.int32)
             for k in ("tokens", "labels")}
    leaves = _leaves(params) + _leaves(state.opt.mu) + _leaves(state.opt.nu) \
        + [state.opt.step] + list(batch.values())
    with FlopCounterMode(display=False) as fc:
        make_train_step(model, opt)(state, batch)
    assert rec["per_device"]["flops"] == fc.get_total_flops() > 0
    assert rec["memory"]["argument_size_bytes"] == sum(
        t.numel() * t.element_size() for t in leaves)
