"""Local Control Objects (paper §4.1): AND-gate LCO and futures.

An AND-gate LCO accumulates values with an operator; when it has been
``set`` N times it fires its trigger action and resets (paper Fig 3:
rhizome-collapse for PageRank).  These are *functional* objects — ``set``
returns a new state — so they compose with functional loops and with the AM-CCA
simulator's event loop alike.

In the dense engine the same counted-trigger semantics lower to a
reduction collective (see ``repro_torch.core.engine``); this module is the
event-driven form used by the simulator and by host-side orchestration.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np

T = typing.TypeVar("T")


@dataclasses.dataclass(frozen=True)
class AndGate(typing.Generic[T]):
    """AND-gate LCO of arity ``target`` with combining operator ``op``."""

    target: int
    op: typing.Callable[[T, T], T]
    identity: T
    value: T = None  # type: ignore[assignment]
    count: int = 0

    def __post_init__(self):
        if self.value is None:
            object.__setattr__(self, "value", self.identity)

    def set(self, contribution: T) -> tuple["AndGate[T]", bool, T]:
        """Apply one contribution. Returns (new_state, fired, fired_value).

        When the gate fires it resets (count=0, value=identity) — matching
        the paper's "the score AND Gate is reset" semantics — and the
        caller runs the trigger action with ``fired_value``.
        """
        if self.count >= self.target:
            raise RuntimeError("AND-gate set after firing without reset")
        new_val = self.op(self.value, contribution)
        new_count = self.count + 1
        if new_count == self.target:
            return (
                AndGate(self.target, self.op, self.identity),
                True,
                new_val,
            )
        return (
            dataclasses.replace(self, value=new_val, count=new_count),
            False,
            new_val,
        )


@dataclasses.dataclass(frozen=True)
class Future(typing.Generic[T]):
    """Write-once future: continuations run when the value is set."""

    ready: bool = False
    value: T = None  # type: ignore[assignment]

    def set(self, value: T) -> "Future[T]":
        if self.ready:
            raise RuntimeError("future already set")
        return Future(True, value)


def and_gate_tree(values: np.ndarray, op, identity, fanin: int = 2):
    """Hierarchical AND-gate reduction (the hardware-signalling analog of
    §4's termination detection): combines ``values`` pairwise through a
    tree of AND gates; returns (result, depth). Used in tests to show the
    counted-trigger form computes the same result as one flat gate."""
    vals = list(values)
    depth = 0
    while len(vals) > 1:
        nxt = []
        for i in range(0, len(vals), fanin):
            grp = vals[i : i + fanin]
            gate = AndGate(target=len(grp), op=op, identity=identity)
            fired_val = identity
            for gvv in grp:
                gate, fired, fired_val = gate.set(gvv)
            assert fired
            nxt.append(fired_val)
        vals = nxt
        depth += 1
    return vals[0] if vals else identity, depth
