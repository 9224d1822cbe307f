"""The dry run's counted recurrences (``lm.launch.dryrun``): a traced
step whose scans each run one trip weighed by the trip count equals the
same step traced with every trip unrolled (``trace(..., unroll=True)``),
for reduced jamba (Mamba) and xlstm (mLSTM and sLSTM) on a fake (2, 2)
mesh at S = 64: per op, calls, FLOPs, bytes, collective kinds and bytes
exactly; temp bytes within 1%.  Training with remat off and on (the
recomputed forward weighed too), and prefill."""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.lm.configs import get_config
from repro_torch.lm.configs.base import ShapeSpec
from repro_torch.lm.launch import dryrun
from repro_torch.lm.launch.mesh import make_test_mesh

TEMP_RTOL = 0.01


@pytest.fixture(autouse=True)
def _one_thread_no_group():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    yield
    torch.set_num_threads(threads)
    assert not dist.is_initialized()


@pytest.fixture
def trips(monkeypatch):
    """Counts the trips the recurrences' scans run."""
    from repro_torch.lm.models import ssm
    n = [0]
    for name in ("_mamba_trip", "_mlstm_trip", "_slstm_trip"):
        def counted(*args, step=getattr(ssm, name)):
            n[0] += 1
            return step(*args)
        monkeypatch.setattr(ssm, name, counted)
    return n


def _trace(cfg, shape, unroll):
    with dryrun.fake_group(4):
        mesh = make_test_mesh((2, 2), device="cpu")
        with dryrun.fake_tensors():
            summary, memory, _ = dryrun.trace(
                dryrun.lower_model(cfg, shape, mesh), unroll=unroll)
    return {row[0]: row[1:] for row in summary["ops"]}, memory


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
@pytest.mark.parametrize("kind,remat", [("train", False), ("train", True),
                                        ("prefill", False)])
def test_counted_trace_equals_unrolled(trips, arch, kind, remat):
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    shape = ShapeSpec("s64", kind, 64, 4)
    counted, cmem = _trace(cfg, shape, unroll=False)
    counted_trips = trips[0]
    unrolled, umem = _trace(cfg, shape, unroll=True)
    # the counted trace ran one trip a scan pass (a forward, a remat's
    # recomputed forward, a backward), the unrolled one every trip
    assert 0 < counted_trips < trips[0] - counted_trips
    assert counted == unrolled
    for k in ("argument_size_bytes", "output_size_bytes"):
        assert cmem[k] == umem[k]
    assert abs(cmem["temp_size_bytes"] - umem["temp_size_bytes"]) <= \
        TEMP_RTOL * umem["temp_size_bytes"]
