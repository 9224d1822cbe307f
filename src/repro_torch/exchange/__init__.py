"""The exchange layer: relax, inter-shard exchange and rhizome collapse.

One implementation of the engine's per-round machinery for the stacked
layout; ``core.engine`` drives it.  Tables are ``(V,)`` per query.
"""
from repro_torch.exchange.primitives import (
    check_ported, collapse, reduce_axis0, relax, stacked_dense_inbox,
)
from repro_torch.exchange.rounds import (
    fixpoint_round_stacked, shard_message_mirror, stacked_collapse,
    stacked_inbox,
)

__all__ = [
    "check_ported", "collapse", "fixpoint_round_stacked", "reduce_axis0",
    "relax", "shard_message_mirror", "stacked_collapse",
    "stacked_dense_inbox", "stacked_inbox",
]
