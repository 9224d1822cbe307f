"""Logical-axis sharding rules -> partition specs (DP/TP/SP/EP/FSDP).

Every parameter and annotated activation carries a tuple of *logical* axis
names. A ruleset maps logical names to the abstract roles ``dp`` / ``tp``
(or None); ``ShardCtx`` binds roles to concrete mesh axes — ``dp`` spans
``("pod", "data")`` on a multi-pod mesh, ``tp`` is ``("model",)``.

``spec_for`` drops any mapping that does not divide the actual dimension
(e.g. 8 KV heads on a 16-way model axis fall back to replicated) —
sharding validity is structural, never a crash.  A spec is a tuple with
one entry a dimension: None, a mesh axis name, or a tuple of names.

``spec_for`` reads the mesh only through its named axis sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and
``shape``) or any object whose ``shape`` maps axis names to sizes.

On a bound ``DeviceMesh`` a spec becomes ``DTensor`` placements
(``placements_for``: one ``Shard(i)`` or ``Replicate()`` a mesh dim),
the counterpart of the reference's ``NamedSharding``.  ``constrain``
redistributes an activation to its placements (a plain tensor, which
every rank holds whole under SPMD, is sliced locally), ``place`` puts a
tree of parameters on the mesh a leaf at a time, and ``local_call`` runs
an op that has no ``DTensor`` sharding rule on each rank's local shard
of explicitly placed operands.  Without a mesh all of them are the
identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

# logical axis -> role ('dp' | 'tp' | None). Anything unlisted is None.
RULESETS: dict[str, dict[str, str | None]] = {
    # TP for compute-parallel dims, FSDP (dp) for the storage-heavy embed
    # dim of weights, SP for the sequence dim of activations.
    "default": {
        "vocab": "tp",
        "embed": "dp",           # FSDP storage shard of weight matrices
        "heads": "tp",
        "kv_heads": "tp",
        "mlp": "tp",
        "experts": "tp",         # EP: experts over the model axis
        "expert_mlp": None,
        "mamba_inner": "tp",
        "lstm_inner": "tp",
        # activations
        "act_batch": "dp",
        "act_seq": "tp",         # sequence parallelism at layer boundaries
        "act_embed": None,
        "act_vocab": "tp",
        "act_heads": "tp",
        "act_kv_heads": "tp",
        "act_experts": "tp",
        "act_kv_seq": None,
        "act_mlp": "tp",
        "act_mamba_inner": "tp",
        "act_frames": None,
    },
    # KV-cache sequence dim sharded over 'tp' — exact for any kv-head
    # count (incl. MQA), keeps the decode working set per device at
    # cache/|tp| instead of the full cache
    "opt": {
        "vocab": "tp", "embed": "dp", "heads": "tp", "kv_heads": "tp",
        "mlp": "tp", "experts": "tp", "expert_mlp": None,
        "mamba_inner": "tp", "lstm_inner": "tp",
        "act_batch": "dp", "act_seq": "tp", "act_embed": None,
        "act_vocab": "tp", "act_heads": "tp", "act_kv_heads": "tp",
        "act_experts": "tp", "act_kv_seq": "tp", "act_mlp": "tp",
        "act_mamba_inner": "tp", "act_frames": None,
    },
    # pure tensor-parallel (no FSDP): small models / serving
    "tp_only": {
        "vocab": "tp", "embed": None, "heads": "tp", "kv_heads": "tp",
        "mlp": "tp", "experts": "tp", "mamba_inner": "tp", "lstm_inner": "tp",
        "act_batch": "dp", "act_seq": None, "act_vocab": "tp",
        "act_heads": "tp", "act_kv_heads": "tp", "act_experts": "tp",
        "act_kv_seq": "tp",   # decode: shard the KV-cache sequence dim
        "act_mlp": "tp", "act_mamba_inner": "tp",
    },
}


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a mesh whose ``shape``
    maps names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(s) for a, s in dict(mesh.shape).items()}


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Binds logical rules to a concrete mesh. mesh=None => no-op."""
    mesh: object | None = None
    rules: str = "default"
    dp: tuple[str, ...] = ("data",)
    tp: tuple[str, ...] = ("model",)

    def role_axes(self, role: str | None):
        if role == "dp":
            return self.dp
        if role == "tp":
            return self.tp
        return None

    def axis_size(self, role: str) -> int:
        if self.mesh is None:
            return 1
        sizes = mesh_axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.role_axes(role))


def spec_for(axes: tuple[str | None, ...], ctx: ShardCtx,
             shape: tuple[int, ...] | None = None) -> tuple:
    """Partition spec for logical axes; drops non-dividing mappings."""
    rules = RULESETS[ctx.rules]
    sizes = mesh_axis_sizes(ctx.mesh) if ctx.mesh is not None else None
    entries = []
    used: set[str] = set()
    for i, name in enumerate(axes):
        role = rules.get(name) if name else None
        mesh_axes = ctx.role_axes(role)
        if mesh_axes is None or any(a in used for a in mesh_axes):
            entries.append(None)
            continue
        if shape is not None and sizes is not None:
            if shape[i] % math.prod(sizes[a] for a in mesh_axes) != 0:
                entries.append(None)
                continue
        used.update(mesh_axes)
        entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    return tuple(entries)


def placements_for(spec: tuple, mesh) -> tuple:
    """A spec tuple -> one ``Shard(i)`` / ``Replicate()`` a mesh dim.  A
    tensor dim over several mesh axes (``("pod", "data")``) is sharded on
    each of them, in the mesh's row-major order, as the reference's
    ``P(("pod", "data"))`` is.  A mesh dim of size 1 replicates (the
    same data, and no view of the tensor then counts as resharding)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_axis_sizes(mesh)
    names = tuple(sizes)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if sizes[a] > 1:      # a mesh dim of one rank holds it whole
                out[names.index(a)] = Shard(i)
    return tuple(out)


def sharding_for(axes, ctx: ShardCtx, shape) -> tuple:
    """(mesh, placements) for logical axes: the reference's
    ``NamedSharding``."""
    assert ctx.mesh is not None
    return ctx.mesh, placements_for(spec_for(axes, ctx, tuple(shape)),
                                    ctx.mesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def gathered(t):
    """The whole value of a ``DTensor`` on this rank (a collective every
    rank calls), its gather finished before the caller reads the bytes
    (a functional collective's result is otherwise waited for only by
    the next op on it); a plain tensor as it is.  No gradient."""
    if not is_dtensor(t):
        return t
    out = t.detach().full_tensor()
    wait = getattr(out, "wait", None)
    return wait() if callable(wait) else out


def constrain(x, axes: tuple[str | None, ...], ctx: ShardCtx | None):
    """Identity without a bound mesh.  On one, a ``DTensor`` is
    redistributed to ``sharding_for``'s placements (its gradient too)
    and a plain tensor (the same on every rank) becomes one, each rank
    slicing its own part."""
    if ctx is None or ctx.mesh is None:
        return x
    from torch.distributed.tensor import distribute_tensor
    mesh, pl = sharding_for(axes, ctx, x.shape)
    if is_dtensor(x):
        # always through redistribute, even to the same placements: its
        # backward puts the gradient in them too, as a sharding
        # constraint does for the cotangent
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


_spmd_depth = 0


@contextlib.contextmanager
def spmd(ctx: ShardCtx | None):
    """On a bound mesh, plain tensors meeting ``DTensor``s count as
    replicated (``implicit_replication``: every rank makes the same
    positions, masks and constants); nests.  Without a mesh: nothing."""
    global _spmd_depth
    if ctx is None or ctx.mesh is None or _spmd_depth:
        _spmd_depth += 1
        try:
            yield
        finally:
            _spmd_depth -= 1
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _spmd_depth += 1
    try:
        with implicit_replication():
            yield
    finally:
        _spmd_depth -= 1


def local_part(full, dst, lead: int = 0):
    """The rank's part of the plain tensor ``full`` under the placements
    of the ``DTensor`` ``dst``, whose first ``lead`` dims ``full`` lacks
    (they must not be sharded)."""
    shape, offset = _local_box(dst)
    return full[tuple(slice(o, o + n) for o, n in
                      zip(offset[lead:], shape[lead:]))]


def constrain_like(x, ref):
    """``x`` in the ``DTensor`` ``ref``'s mesh and placements (a plain
    ``x`` is sliced locally)."""
    from torch.distributed.tensor import distribute_tensor
    if is_dtensor(x):
        return x.redistribute(ref.device_mesh, ref.placements)
    return distribute_tensor(x, ref.device_mesh, ref.placements,
                             src_data_rank=None)


def place(tree, axes_tree, ctx: ShardCtx | None):
    """``jax.device_put(tree, shardings)``: each leaf placed by its
    logical axes, one leaf at a time."""
    if isinstance(tree, dict):
        return {k: place(v, axes_tree[k], ctx) for k, v in tree.items()}
    out = constrain(tree, axes_tree, ctx)
    if is_dtensor(out) and not is_dtensor(tree):
        # the shard gets storage of its own: a view would keep the whole
        # leaf alive
        from torch.distributed.tensor import DTensor
        out = DTensor.from_local(out.to_local().clone(), out.device_mesh,
                                 out.placements, run_check=False)
    return out


def _local_box(leaf):
    """(local shape, global offset) of a placed leaf: shape arithmetic,
    run with every dispatch mode off (torch builds index tensors for
    it, which a fake-tensor trace must neither fake nor count)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        shape, offset = compute_local_shape_and_global_offset(
            leaf.shape, leaf.device_mesh, leaf.placements)
    return tuple(int(n) for n in shape), tuple(int(o) for o in offset)


def local_shape(leaf) -> tuple:
    """The rank's shard shape of a placed leaf (a plain tensor: its
    shape): the reference's ``NamedSharding.shard_shape``."""
    return _local_box(leaf)[0] if is_dtensor(leaf) else tuple(leaf.shape)


def local_offset(leaf) -> tuple:
    """Where the rank's shard of a placed leaf starts in each dim."""
    return _local_box(leaf)[1]


def pointwise(fn, x):
    """``fn`` (an elementwise op with no ``DTensor`` rule) on each rank's
    shard of ``x``, the placements kept (a pending sum is reduced
    first); a plain ``x``: ``fn(x)``."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = tuple(Replicate() if isinstance(q, Partial) else q
               for q in x.placements)
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False)


def local_call(fn, ctx: ShardCtx | None, in_axes, out_axes):
    """Wrap ``fn`` for an op with no ``DTensor`` sharding rule.  Each
    tensor argument is constrained to its logical axes (``None``: a
    plain argument passed as it is) and ``fn`` runs on the rank's local
    shards; each output is wrapped back with the mesh axes its logical
    dims took in the inputs (a dim named there takes the same mesh
    axes, any other is replicated).  The values equal ``fn``'s on the
    whole tensors as long as ``fn`` treats the sharded dims row by row.
    An input replicated over a mesh dim that an output is sharded over
    gets a pending sum there as its gradient (each rank's part of the
    work adds to it); ``fn`` must not return a replicated and a sharded
    output over one mesh dim that both depend on such an input.
    Without a mesh: ``fn`` itself."""
    if ctx is None or ctx.mesh is None:
        return fn
    multi = bool(out_axes) and all(isinstance(a, tuple) for a in out_axes)

    def call(*args):
        from torch.distributed.tensor import DTensor, Partial
        taken: dict[str, object] = {}
        placed = []
        for a, ax in zip(args, in_axes):
            if ax is None:
                placed.append(None)
                continue
            spec = spec_for(ax, ctx, tuple(a.shape))
            for name, entry in zip(ax, spec):
                if name is not None and entry is not None:
                    taken[name] = entry
            placed.append(constrain(a, ax, ctx))
        out_pl = [placements_for(tuple(taken.get(n) if n is not None
                                       else None for n in ax), ctx.mesh)
                  for ax in (out_axes if multi else (out_axes,))]
        split = {i for pl in out_pl for i, q in enumerate(pl) if q.is_shard()}
        local = []
        for a, c in zip(args, placed):
            if c is None:
                local.append(a)
                continue
            grad_pl = tuple(Partial() if i in split and not q.is_shard()
                            else q for i, q in enumerate(c.placements))
            local.append(c.to_local(grad_placements=grad_pl))
        outs = fn(*local)
        outs = outs if multi else (outs,)
        wrapped = tuple(DTensor.from_local(o, ctx.mesh, pl, run_check=False)
                        for o, pl in zip(outs, out_pl))
        return wrapped if multi else wrapped[0]

    return call
