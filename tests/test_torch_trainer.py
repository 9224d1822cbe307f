"""The port's ``Trainer``: the reference's four trainer checks (loss
decreases, checkpoint/restart resumes exactly, gradient compression
trains, error feedback bounds the drift), and a run from the reference's
weights and ``OptState`` whose ``history`` and final parameters track
the reference ``Trainer``'s.  The port runs on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data.pipeline import TokenPipeline as RefPipeline  # noqa: E402
from repro.lm.configs import get_config as ref_config  # noqa: E402
from repro.lm.models.model import Model as RefModel  # noqa: E402
from repro.lm.train.optimizer import AdamW as RefAdamW  # noqa: E402
from repro.lm.train.trainer import Trainer as RefTrainer  # noqa: E402
from repro.lm.train.trainer import TrainerConfig as RefTrainerConfig  # noqa: E402,E501
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    lm_params_from_numpy, lm_params_to_numpy, opt_state_from_numpy)
from repro_torch.lm.configs import get_config  # noqa: E402
from repro_torch.lm.models.model import Model, _flatten  # noqa: E402
from repro_torch.lm.train import AdamW  # noqa: E402
from repro_torch.lm.train.train_step import TrainState  # noqa: E402
from repro_torch.lm.train.trainer import (  # noqa: E402
    SimulatedFailure, Trainer, TrainerConfig)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small ops run in six test workers at
    once, where torch's default thread pool spins against the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "phi3-medium-14b"


def _small_setup(tmp_path, steps=30, compress=False, ckpt_every=10,
                 async_ckpt=False):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), vocab=128)
    model = Model(cfg, device="cpu")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0)
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                         ckpt_dir=str(tmp_path), log_every=5,
                         async_ckpt=async_ckpt, compress_grads=compress)
    return Trainer(model, AdamW(lr=1e-3, weight_decay=0.0), pipe, tcfg)


def test_loss_decreases(tmp_path):
    tr = _small_setup(tmp_path / "a", steps=30)
    tr.run()
    first = tr.history[0]["ce"]
    last = tr.history[-1]["ce"]
    assert last < first - 0.1, tr.history


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_restart_resumes_exactly(tmp_path, async_ckpt):
    # run 1: train 20 steps, checkpointing every 10
    tr1 = _small_setup(tmp_path / "b", steps=20, ckpt_every=10,
                       async_ckpt=async_ckpt)
    final1 = tr1.run()

    # run 2: same config; dies at step 15, restarted, resumes from 10
    tr2 = _small_setup(tmp_path / "c", steps=20, ckpt_every=10,
                       async_ckpt=async_ckpt)

    def bomb(step):
        if step == 15 and not getattr(bomb, "fired", False):
            bomb.fired = True
            raise SimulatedFailure()

    with pytest.raises(SimulatedFailure):
        tr2.run(failure_hook=bomb)
    tr2.ckpt.wait()
    assert tr2.ckpt.latest_step() == 10
    final2 = tr2.run()  # auto-resumes from step 10
    assert tr2.history[-1]["step"] == 20

    a, b = _flatten(final1.params), _flatten(final2.params)
    for k in a:
        assert torch.equal(a[k], b[k]), k      # bit for bit on the CPU
    assert int(final1.opt.step) == int(final2.opt.step) == 20
    for k, m in _flatten(final1.opt.mu).items():
        assert torch.equal(m, _flatten(final2.opt.mu)[k]), k


def test_gradient_compression_trains(tmp_path):
    tr = _small_setup(tmp_path / "d", steps=30, compress=True)
    tr.run()
    assert tr.history[-1]["ce"] < tr.history[0]["ce"] - 0.1


def test_compression_error_feedback_bounds_drift(tmp_path):
    """int8+feedback stays close to the uncompressed trajectory."""
    tr_ref = _small_setup(tmp_path / "e", steps=15)
    tr_ref.run()
    tr_c = _small_setup(tmp_path / "f", steps=15, compress=True)
    tr_c.run()
    # same data/seed => trajectories comparable; allow quantization drift
    ref_l = tr_ref.history[-1]["ce"]
    comp_l = tr_c.history[-1]["ce"]
    assert abs(ref_l - comp_l) < 0.5


def test_bfloat16_training_checkpoints_restore(tmp_path):
    """bfloat16 parameters (every full-width config's) checkpoint and
    resume bit for bit."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), vocab=128,
                              dtype="bfloat16", param_dtype="bfloat16")
    runs = []
    for name, hook in (("g", None), ("h", "bomb")):
        tr = Trainer(Model(cfg, device="cpu"), AdamW(lr=1e-3),
                     TokenPipeline(vocab=128, seq_len=8, global_batch=4),
                     TrainerConfig(steps=6, ckpt_every=2, log_every=1,
                                   ckpt_dir=str(tmp_path / name)))
        if hook:
            def bomb(step):
                if step == 5 and not getattr(bomb, "fired", False):
                    bomb.fired = True
                    raise SimulatedFailure()
            with pytest.raises(SimulatedFailure):
                tr.run(failure_hook=bomb)
        runs.append(tr.run())
    a, b = (_flatten(r.params) for r in runs)
    assert a["embed.table"].dtype == torch.bfloat16
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_trainer_tracks_the_reference_trainer(tmp_path):
    """Both trainers from the reference's weights and ``OptState``, on
    the same pipeline: per-step ``ce`` within rtol 1e-4 and final weights
    within the reference's ``tests/test_grad_accum.py`` tolerance."""
    steps, lr = 6, 1e-3
    rcfg = dataclasses.replace(ref_config(ARCH).reduced(), vocab=128)
    pcfg = dataclasses.replace(get_config(ARCH).reduced(), vocab=128)
    rtr = RefTrainer(
        RefModel(rcfg), RefAdamW(lr=lr), RefPipeline(
            vocab=128, seq_len=16, global_batch=8, seed=0),
        RefTrainerConfig(steps=steps, ckpt_every=100, log_every=1,
                         ckpt_dir=str(tmp_path / "ref"), async_ckpt=False))
    rstate = rtr.init_state(3)
    np_params = jax.tree.map(np.asarray, rstate.params)
    np_opt = jax.tree.map(np.asarray, rstate.opt)
    rfinal = rtr.run(rstate)

    model = Model(pcfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(pcfg, np_params))
    ptr = Trainer(model, AdamW(lr=lr), TokenPipeline(
        vocab=128, seq_len=16, global_batch=8, seed=0),
        TrainerConfig(steps=steps, ckpt_every=100, log_every=1,
                      ckpt_dir=str(tmp_path / "port"), async_ckpt=False))
    pfinal = ptr.run(TrainState(model.param_tree(),
                                opt_state_from_numpy(np_opt, "cpu"), None))

    assert [h["step"] for h in ptr.history] == \
        [h["step"] for h in rtr.history] == list(range(1, steps + 1))
    for ph, rh in zip(ptr.history, rtr.history):
        assert set(ph) == set(rh)
        for k in rh:
            np.testing.assert_allclose(ph[k], rh[k], rtol=1e-4, err_msg=k)
    got = _flatten(lm_params_to_numpy(pfinal.params))
    want = _flatten(jax.tree.map(np.asarray, rfinal.params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=6e-4,
                                   err_msg=k)
