"""The exchange layer: relax, inter-shard exchange and rhizome collapse.

One implementation of the engine's per-round machinery for the stacked
layout — relax, the dense or compact targeted exchange, the rhizome
collapse; ``core.engine`` and ``query.lanes`` drive it.  Tables are
``(V,)`` for one query or ``(V, Q)`` for Q query lanes.
"""
from repro_torch.exchange.primitives import (
    collapse, compact_collapse, exchange_volume, inbox_index, reduce_axis0,
    relax, scatter_inbox, stacked_compact_partial, stacked_dense_inbox,
)
from repro_torch.exchange.rounds import (
    axis_tuple, delta_pagerank_round_stacked, delta_pagerank_window_stacked,
    expected_round_messages, fixpoint_round_stacked, fixpoint_window_stacked,
    mask_shard_frontier, pagerank_round_stacked, shard_message_mirror,
    stacked_collapse, stacked_inbox, stacked_total_in,
)

__all__ = [
    "axis_tuple", "collapse", "compact_collapse",
    "delta_pagerank_round_stacked", "delta_pagerank_window_stacked",
    "exchange_volume", "expected_round_messages", "fixpoint_round_stacked",
    "fixpoint_window_stacked", "inbox_index", "mask_shard_frontier",
    "pagerank_round_stacked", "reduce_axis0", "relax", "scatter_inbox",
    "shard_message_mirror", "stacked_collapse", "stacked_compact_partial",
    "stacked_dense_inbox", "stacked_inbox", "stacked_total_in",
]
