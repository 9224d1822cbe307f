"""The port's launch specs and training CLI against the reference's, on
the CPU: ``param_count`` / ``active_param_count`` / ``model_flops`` for
all ten archs at full width, the abstract (``meta``) inputs, parameters,
optimizer state and caches, and ``python -m
repro_torch.lm.launch.train --device cpu --reduced``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.lm.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.lm.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.lm.launch import specs as ref_specs  # noqa: E402
from repro.lm.models.model import Model as RefModel  # noqa: E402
from repro_torch.lm.configs import ARCHS  # noqa: E402
from repro_torch.lm.configs.base import SHAPES  # noqa: E402
from repro_torch.lm.launch import specs, train  # noqa: E402
from repro_torch.lm.models.model import Model, _flatten  # noqa: E402
from repro_torch.lm.train import AdamW  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small ops run in six test workers at
    once, where torch's default thread pool spins against the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# launch specs and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_and_model_flops_equal_reference(arch, monkeypatch):
    # the reference counts a full-width model's parameters by tracing its
    # init; count once, as every other count here reads it
    monkeypatch.setattr(ref_specs, "param_count",
                        functools.lru_cache(ref_specs.param_count))
    rcfg, pcfg = REF_ARCHS[arch], ARCHS[arch]
    assert specs.param_count(pcfg) == ref_specs.param_count(rcfg)
    assert specs.active_param_count(pcfg) == \
        ref_specs.active_param_count(rcfg)
    for name in SHAPES:
        assert specs.model_flops(pcfg, SHAPES[name]) == \
            ref_specs.model_flops(rcfg, REF_SHAPES[name])


@pytest.mark.parametrize("arch", ["whisper-medium", "paligemma-3b"])
def test_abstract_specs_equal_reference(arch):
    rcfg, pcfg = REF_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    for name in ("train_4k", "decode_32k"):
        want = ref_specs.input_specs(rcfg, REF_SHAPES[name])
        got = specs.input_specs(pcfg, SHAPES[name])
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
    model = Model(pcfg, device="meta")
    shapes, axes = specs.abstract_params(model)
    rshapes, raxes = ref_specs.abstract_params(RefModel(rcfg))
    assert axes == raxes
    assert {k: tuple(v.shape) for k, v in _flatten(shapes).items()} == \
        {k: tuple(v.shape) for k, v in _flatten(rshapes).items()}
    opt = specs.abstract_opt_state(AdamW(), shapes, axes, None)
    assert all(v.dtype == torch.float32 and v.device.type == "meta"
               for v in _flatten(opt.mu).values())
    caches, cax = specs.abstract_caches(model, 2, 16, None)
    assert cax == ref_specs.abstract_caches(RefModel(rcfg), 2, 16, None)[1]


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    tr = train.main(["--arch", "minitron-4b", "--reduced", "--steps", "12",
                     "--global-batch", "4", "--seq-len", "16", "--device",
                     "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "6"])
    out = capsys.readouterr().out.strip().splitlines()
    assert [r["step"] for r in tr.history] == [1, 10]
    assert out[0].startswith("step=1,ce=") and "grad_norm=" in out[0]
    assert tr.ckpt.all_steps() == [6, 12]
    assert all(np.isfinite(v) for r in tr.history for v in r.values())


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-medium"])
def test_train_cli_stub_inputs(tmp_path, arch):
    """The VLM / enc-dec stub inputs are drawn per step from a seeded
    generator: a rerun gives the same history."""
    runs = [train.main(["--arch", arch, "--reduced", "--steps", "2",
                        "--global-batch", "2", "--seq-len", "8", "--device",
                        "cpu", "--ckpt-dir", str(tmp_path / str(i))]).history
            for i in range(2)]
    assert runs[0] == runs[1] and len(runs[0]) == 1


def test_train_cli_mesh_is_not_ported():
    """``--mesh`` is ported (``tests/test_torch_lm_mesh_cli.py`` runs it
    under torchrun); outside a world of ``D*M`` ranks it raises, naming
    both counts."""
    with pytest.raises(ValueError, match="needs 4 ranks, WORLD_SIZE is 1"):
        train.main(["--arch", "minitron-4b", "--reduced", "--device", "cpu",
                    "--mesh", "2,2"])
