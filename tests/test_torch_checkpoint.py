"""The port's ``CheckpointManager`` against the reference's.

The same cases as the reference's own (``tests/test_checkpoint.py``):
round trips, latest step and garbage collection, async saves, a crash
mid-save, crc verification, async write failures, the ``meta`` dict —
with trees of torch tensors and of numpy arrays.  Each package restores
what the other wrote, leaf for leaf, and both write the same files with
the same crc-32s.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as RefManager  # noqa: E402,E501
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import manager as manager_mod  # noqa: E402


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": np.arange(7, dtype=np.int32),
                  "d": np.float32(seed)},
            "e": [np.ones(3, bool), (np.int64(seed), np.zeros(2))]}


def _torch_tree(seed):
    t = _np_tree(seed)
    return {"a": torch.as_tensor(t["a"]),
            "b": {"c": torch.as_tensor(t["b"]["c"]), "d": t["b"]["d"]},
            "e": [torch.as_tensor(t["e"][0]), t["e"][1]]}


def _zeros_like(tree):
    return manager_mod._unflatten(
        tree, {p: 0 for p, _ in manager_mod._flatten(tree)})


def _assert_tree_equal(want, got):
    a = manager_mod._flatten(want)
    b = manager_mod._flatten(got)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype, p
        np.testing.assert_array_equal(x, y, err_msg=str(p))


TREES = {"torch": _torch_tree, "numpy": _np_tree}


@pytest.mark.parametrize("kind", TREES)
def test_save_restore_roundtrip(tmp_path, kind):
    cm = CheckpointManager(str(tmp_path))
    t = TREES[kind](0)
    cm.save(10, t)
    got = cm.restore(10, _zeros_like(t))
    _assert_tree_equal(t, got)
    assert isinstance(got["a"], np.ndarray)
    got = cm.restore(10, t, device="cpu")
    assert isinstance(got["a"], torch.Tensor)
    _assert_tree_equal(t, got)
    assert isinstance(got["e"][1], tuple)


def test_latest_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _torch_tree(s))
    assert cm.latest_step() == 4
    assert cm.all_steps() == [3, 4]  # older GC'd


@pytest.mark.parametrize("kind", TREES)
def test_async_save(tmp_path, kind):
    cm = CheckpointManager(str(tmp_path))
    t = TREES[kind](3)
    cm.save(7, t, blocking=False)
    cm.wait()
    step, got = cm.restore_latest(_zeros_like(t))
    assert step == 7
    _assert_tree_equal(t, got)


def test_async_save_copies_before_the_writer_starts(tmp_path):
    """The host copy is taken on the caller's thread: changing a tensor
    right after ``save(..., blocking=False)`` does not reach the disk."""
    cm = CheckpointManager(str(tmp_path))
    t = _torch_tree(4)
    want = t["a"].clone()
    cm.save(1, t, blocking=False)
    t["a"].add_(100.0)
    cm.wait()
    got = cm.restore(1, t, device="cpu")
    torch.testing.assert_close(got["a"], want, rtol=0, atol=0)


def test_crash_mid_save_leaves_previous_intact(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _torch_tree(1))
    # simulate a crash: a stale .tmp dir from a dead writer
    os.makedirs(str(tmp_path / "step_0000000002.tmp"))
    assert cm.latest_step() == 1
    # a new save of step 2 succeeds over the stale tmp
    cm.save(2, _torch_tree(2))
    assert cm.latest_step() == 2


def test_corruption_detected(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = _torch_tree(5)
    path = cm.save(11, t)
    # flip bytes in one leaf
    fname = os.path.join(path, "a.npy")
    arr = np.load(fname)
    arr[0, 0] += 1.0
    np.save(fname, arr)
    with pytest.raises(IOError, match="corrupt"):
        cm.restore(11, t)


def test_async_write_failure_surfaces(tmp_path):
    """A failed background save must not die silently: the writer
    thread's exception re-raises on the next wait()/save()."""
    cm = CheckpointManager(str(tmp_path))
    t = _torch_tree(1)
    cm.save(1, t, blocking=False)
    cm.wait()                              # clean write: no raise
    # point the writer at an unwritable location (a file, not a dir)
    blocked = tmp_path / "blocked"
    blocked.write_text("not a directory")
    cm.dir = str(blocked)
    cm.save(2, t, blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        cm.wait()
    # the error is consumed: the manager is usable again
    cm.dir = str(tmp_path)
    cm.save(3, t, blocking=False)
    cm.wait()
    assert cm.latest_step() == 3


def test_async_write_failure_surfaces_on_next_save(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = _torch_tree(2)
    blocked = tmp_path / "blocked2"
    blocked.write_text("not a directory")
    cm.dir = str(blocked)
    cm.save(1, t, blocking=False)
    cm.dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        cm.save(2, t)                      # save() waits first


def test_meta_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    meta = {"round": 7, "run": "sssp", "nested": {"k": [1, 2]}}
    cm.save(7, _torch_tree(7), meta=meta)
    assert cm.restore_meta(7) == meta
    cm.save(8, _torch_tree(8))             # no meta -> empty dict
    assert cm.restore_meta(8) == {}


# ------------------------------------------------- across the two packages
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_package_restore(tmp_path, writer):
    """A checkpoint either package writes restores in the other, leaf for
    leaf; both write the same files, shapes, dtypes and crc-32s."""
    t = _np_tree(9)
    meta = {"round": 3, "S": 4}
    dirs = {"reference": tmp_path / "ref", "port": tmp_path / "port"}
    RefManager(str(dirs["reference"])).save(3, t, meta=meta)
    CheckpointManager(str(dirs["port"])).save(3, _torch_tree(9), meta=meta)
    manifests = [json.loads((d / "step_0000000003" / "manifest.json")
                            .read_text()) for d in dirs.values()]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    assert manifests[0]["meta"] == manifests[1]["meta"] == meta
    reader = (CheckpointManager if writer == "reference" else RefManager)(
        str(dirs[writer]))
    got = reader.restore(3, _zeros_like(t))
    _assert_tree_equal(t, {k: got[k] for k in t})
    assert reader.restore_meta(3) == meta
