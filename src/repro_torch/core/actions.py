"""Action vocabulary (paper §5): an action = (predicate, work, diffuse).

The engine executes actions in bulk as semiring relaxation steps; the
``Semiring`` here is the algebra of one action class:

* ``relax(src_val, w)``   — message payload built during *diffuse*.
* ``combine``             — how the inbox merges (min for BFS/SSSP, + for PR).
* ``improved(new, old)``  — the *predicate*: does this action perform work?
  (False ⇒ the action — and its diffusion — is pruned, Listing 6.)

``identity`` is the value of a pruned/padded message, so pruning is a
select, never a data-dependent shape.  Every callable takes and returns
torch tensors.
"""
from __future__ import annotations

import dataclasses
import math
import typing

import torch


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    identity: float                       # combine identity
    combine: typing.Callable              # (a, b) -> a⊕b, elementwise
    relax: typing.Callable                # (src_val, w) -> msg
    improved: typing.Callable             # (new, old) -> bool  (the predicate)
    segment: str                          # 'min' | 'sum' — inbox reduction kind
    # static relax selector for the fused kernel — the relax must be
    # expressible inside the kernel: 'add_w' (min-plus), 'add_one' (BFS
    # level), 'mul_w' (plus-times).  Construct ``relax`` from RELAX_FNS
    # (as the built-ins below do) so the two can never disagree; None
    # means "no kernel form" and the fused path refuses to run.
    relax_kind: str | None = None

    def segment_combine(self, data, segment_ids, num_segments):
        """Inbox reduction. Empty segments get the combine identity."""
        if self.segment not in ("min", "sum"):
            raise ValueError(self.segment)
        init = torch.full((num_segments,), self.identity, dtype=data.dtype,
                          device=data.device)
        reduce = "amin" if self.segment == "min" else "sum"
        return init.scatter_reduce_(0, segment_ids.long(), data, reduce,
                                    include_self=True)


# the relax vocabulary expressible inside the fused kernel — the single
# source for both the plain path (via Semiring.relax) and the kernel
# (via Semiring.relax_kind)
RELAX_FNS = {
    "add_w": lambda v, w: v + w,       # min-plus (SSSP)
    "add_one": lambda v, w: v + 1.0,   # BFS level relax (weight ignored)
    "mul_w": lambda v, w: v * w,       # plus-times (PageRank)
}


# BFS: level relaxation. msg = src_level + 1 (weights forced to 1).
BFS = Semiring(
    name="bfs",
    identity=math.inf,
    combine=torch.minimum,
    relax=RELAX_FNS["add_one"],
    improved=lambda new, old: new < old,
    segment="min",
    relax_kind="add_one",
)

# SSSP: min-plus.
SSSP = Semiring(
    name="sssp",
    identity=math.inf,
    combine=torch.minimum,
    relax=RELAX_FNS["add_w"],
    improved=lambda new, old: new < old,
    segment="min",
    relax_kind="add_w",
)

# PageRank: plus-times; edge weight is pre-folded to 1/out_deg(src).
PAGERANK = Semiring(
    name="pagerank",
    identity=0.0,
    combine=lambda a, b: a + b,
    relax=RELAX_FNS["mul_w"],
    improved=lambda new, old: torch.ones_like(new, dtype=torch.bool),
    segment="sum",
    relax_kind="mul_w",
)

SEMIRINGS = {s.name: s for s in (BFS, SSSP, PAGERANK)}
