"""Fault-tolerant checkpointing: atomic, content-verified, async-capable.

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per tree leaf (keyed by
its flattened path) + ``manifest.json`` (tree structure, shapes, dtypes,
crc32s, step, meta). Writes go to ``step_<N>.tmp`` and are renamed only
after fsync — a crash mid-save never corrupts the latest checkpoint.

Trees are flattened as the reference package flattens its pytrees: dict
keys sorted, list and tuple children by index (a named tuple's by
``.field``), the path's parts joined with ``__`` (``_flat_key``),
``None`` holding no leaf.  So a checkpoint
either package writes restores in the other.

``save(..., blocking=False)`` hands the write to a thread.  Every leaf
— a CUDA tensor included — is copied to a host numpy array on the
caller's thread first, so the writer thread never touches the device; a
failed background write re-raises on the next ``save()`` / ``wait()``.
``restore(step, like, device=None)`` returns numpy leaves, or tensors on
``device``.

A tree with ``DTensor`` leaves (sharded LM training) is saved by every
rank of its mesh together: each leaf is gathered whole with
``full_tensor()`` (a collective on every rank) and the world's rank 0
alone writes, in the same format, so a sharded checkpoint restores
unsharded in either package; ``wait`` then also waits for every rank.
Restoring into a ``like`` with ``DTensor`` leaves gives each rank its
own shard of each leaf, placed like ``like``'s.

A bfloat16 leaf is written as the reference writes one: its 2-byte
payload as a ``'<V2'`` ``.npy`` with ``"dtype": "bfloat16"`` in the
manifest and the crc-32 over those bytes.  Restored onto a device it is a
``torch.bfloat16`` tensor again; restored without one it is the raw
``'V2'`` array (``.view(np.int16)`` gives its bits), as NumPy loads it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.sharding.specs import gathered, is_dtensor


def _flat_key(path) -> str:
    return "__".join(str(p) for p in path) or "leaf"


def _flatten(tree, path=()):
    """[(path, leaf)] in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in _flatten(x, path + (_child(tree, i),))]
    return [(path, tree)]


def _child(node, i):
    """A sequence child's path part: its index, or ``.field`` for a
    named tuple (the reference's attribute key)."""
    return f".{node._fields[i]}" if hasattr(node, "_fields") else i


def _unflatten(like, leaves, path=()):
    """``like``'s structure with each leaf taken from ``leaves[path]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, path + (k,))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        kids = [_unflatten(x, leaves, path + (_child(like, i),))
                for i, x in enumerate(like)]
        if isinstance(like, list):
            return kids
        return type(like)(*kids) if hasattr(like, "_fields") \
            else type(like)(kids)
    return leaves[path]


def _structure(tree) -> str:
    """A readable record of the tree's shape (leaves as ``*``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(x) for x in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


BF16 = "bfloat16"


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array, copied now (blocking for a CUDA
    tensor, so no later reader races the copy), and its dtype's name.
    A bfloat16 tensor's bits travel as a ``'V2'`` array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy().view("V2"), BF16
        arr = t.numpy().copy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _device_leaf(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.as_tensor(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 shard_suffix: str = ""):
        self.dir = directory
        self.keep = keep
        self.shard_suffix = shard_suffix
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._async_error: BaseException | None = None
        self._sharded = False     # saved DTensor trees: ranks sync

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = True,
             meta: dict | None = None) -> str:
        self.wait()
        leaves = _flatten(tree)
        if any(is_dtensor(leaf) for _, leaf in leaves):
            import torch.distributed as dist
            self._sharded = True
            # every rank takes part in each gather; rank 0 alone copies
            # the whole leaf to the host, one leaf at a time
            writer = dist.get_rank() == 0
            host = []
            for p, leaf in leaves:
                full = gathered(leaf)
                if writer:
                    host.append((_flat_key(p),) + _host(full))
                del full
            if not writer:
                return self._final_path(step)
        else:
            host = [(_flat_key(p),) + _host(leaf) for p, leaf in leaves]
        structure = _structure(tree)
        if blocking:
            return self._write(step, host, structure, meta)
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host, structure, meta),
            daemon=True)
        self._thread.start()
        return self._final_path(step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            import torch.distributed as dist
            dist.barrier()
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise RuntimeError(
                "async checkpoint write failed") from err

    def _write_guarded(self, step, host, structure, meta):
        # writer-thread shim: a failed background save must not die
        # silently — the exception re-raises on the next save()/wait()
        try:
            self._write(step, host, structure, meta)
        except BaseException as e:  # noqa: BLE001
            self._async_error = e

    def _final_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _write(self, step: int, host, structure: str, meta=None) -> str:
        final = self._final_path(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "treedef": structure, "leaves": {},
                    "meta": meta if meta is not None else {}}
        for key, arr, dtype in host:
            fname = f"{key}{self.shard_suffix}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": dtype,
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._final_path(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, device=None, verify: bool = True):
        """Restore into the structure of ``like``: numpy leaves, or
        tensors on ``device`` when one is given (a ``DTensor`` leaf of
        ``like``: its placements, on its own device)."""
        path = self._final_path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for p, ref in _flatten(like):
            key = _flat_key(p)
            meta = manifest["leaves"][key]
            arr = np.load(os.path.join(path, meta["file"]))
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != meta["crc32"]:
                    raise IOError(f"checkpoint leaf {key} corrupt "
                                  f"(crc {crc} != {meta['crc32']})")
            if is_dtensor(ref):
                from torch.distributed.tensor import distribute_tensor
                arr = distribute_tensor(
                    _device_leaf(arr, meta["dtype"], ref.to_local().device),
                    ref.device_mesh, ref.placements, src_data_rank=None)
            elif device is not None:
                arr = _device_leaf(arr, meta["dtype"], device)
            leaves[p] = arr
        return _unflatten(like, leaves)

    def restore_meta(self, step: int) -> dict:
        """The JSON ``meta`` dict stored alongside step ``step``'s leaves
        (empty for checkpoints written without one)."""
        with open(os.path.join(self._final_path(step),
                               "manifest.json")) as f:
            return json.load(f).get("meta", {})

    def restore_latest(self, like, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, device)
