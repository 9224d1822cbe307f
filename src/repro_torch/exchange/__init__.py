"""The exchange layer: relax, inter-shard exchange and rhizome collapse.

One implementation of the engine's per-round machinery for the stacked
and the sharded layout — relax, the dense or compact targeted exchange,
the rhizome collapse; ``core.engine`` and ``query.lanes`` drive it.
Tables are ``(V,)`` for one query or ``(V, Q)`` for Q query lanes.  The
sharded layout's collectives (``torch.distributed``) are in
``exchange.collectives``.
"""
from repro_torch.exchange import collectives
from repro_torch.exchange.primitives import (
    collapse, compact_collapse, exchange_volume, inbox_index, reduce_axis0,
    relax, scatter_inbox, stacked_compact_partial, stacked_dense_inbox,
)
from repro_torch.exchange.collectives import axis_tuple
from repro_torch.exchange.rounds import (
    delta_pagerank_round_shard, delta_pagerank_round_stacked,
    delta_pagerank_window_stacked, expected_round_messages,
    fixpoint_round_stacked, fixpoint_window_stacked,
    make_shard_fixpoint_round, mask_shard_frontier, pagerank_round_stacked,
    shard_collapse, shard_gather, shard_inbox, shard_message_mirror,
    shard_total_in, stacked_collapse, stacked_inbox, stacked_total_in,
)

__all__ = [
    "axis_tuple", "collapse", "collectives", "compact_collapse",
    "delta_pagerank_round_shard", "delta_pagerank_round_stacked",
    "delta_pagerank_window_stacked",
    "exchange_volume", "expected_round_messages", "fixpoint_round_stacked",
    "fixpoint_window_stacked", "inbox_index", "make_shard_fixpoint_round",
    "mask_shard_frontier", "pagerank_round_stacked", "reduce_axis0",
    "relax", "scatter_inbox", "shard_collapse", "shard_gather",
    "shard_inbox", "shard_message_mirror", "shard_total_in",
    "stacked_collapse", "stacked_compact_partial",
    "stacked_dense_inbox", "stacked_inbox", "stacked_total_in",
]
