"""Logical-axis sharding rules -> partition specs (DP/TP/SP/EP/FSDP).

Every parameter and annotated activation carries a tuple of *logical* axis
names. A ruleset maps logical names to the abstract roles ``dp`` / ``tp``
(or None); ``ShardCtx`` binds roles to concrete mesh axes — ``dp`` spans
``("pod", "data")`` on a multi-pod mesh, ``tp`` is ``("model",)``.

``spec_for`` drops any mapping that does not divide the actual dimension
(e.g. 8 KV heads on a 16-way model axis fall back to replicated) —
sharding validity is structural, never a crash.  A spec is a tuple with
one entry a dimension: None, a mesh axis name, or a tuple of names.

The mesh is read only through its named axis sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and
``shape``) or any object whose ``shape`` maps axis names to sizes.  The
one-device serving and training paths bind no mesh; ``constrain`` on a
bound mesh waits for sharded LM training (ROADMAP Queue 1, item 12c).
"""
from __future__ import annotations

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


def constrain(x, axes: tuple[str | None, ...], ctx: ShardCtx | None):
    """Identity without a bound mesh.  Placing activations on a mesh is
    sharded LM training's work (ROADMAP Queue 1, item 12c)."""
    if ctx is None or ctx.mesh is None:
        return x
    raise NotImplementedError(
        "constrain on a bound mesh is not ported yet (ROADMAP Queue 1, "
        "item 12c: sharded LM training)")
