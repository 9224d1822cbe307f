"""The exchange layer: relax, inter-shard exchange and rhizome collapse.

One implementation of the engine's per-round machinery for the stacked
layout; ``core.engine`` and ``query.lanes`` drive it.  Tables are
``(V,)`` for one query or ``(V, Q)`` for Q query lanes.
"""
from repro_torch.exchange.primitives import (
    check_ported, collapse, reduce_axis0, relax, stacked_dense_inbox,
)
from repro_torch.exchange.rounds import (
    delta_pagerank_round_stacked, delta_pagerank_window_stacked,
    fixpoint_round_stacked, fixpoint_window_stacked, pagerank_round_stacked,
    shard_message_mirror, stacked_collapse, stacked_inbox, stacked_total_in,
)

__all__ = [
    "check_ported", "collapse", "delta_pagerank_round_stacked",
    "delta_pagerank_window_stacked", "fixpoint_round_stacked",
    "fixpoint_window_stacked", "pagerank_round_stacked", "reduce_axis0",
    "relax", "shard_message_mirror", "stacked_collapse",
    "stacked_dense_inbox", "stacked_inbox", "stacked_total_in",
]
