"""Round compositions over the exchange primitives (stacked layout).

One relax → exchange → rhizome-collapse composition for monotone
fixpoints over the unlaned ``(S, R_max)`` tables.  ``core.engine`` is a
thin loop over it — the round loop, termination check and stats
bookkeeping live there; the per-round math lives here, once.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.actions import Semiring
from repro_torch.exchange.primitives import (
    check_ported, collapse, stacked_dense_inbox,
)


def _flat(table):
    """Collapse the leading (shard, slot) dims."""
    return table.reshape((-1,) + tuple(table.shape[2:]))


# --------------------------------------------------------------------------
# stacked layout: all shards resident as a leading S axis on one device
# --------------------------------------------------------------------------

def stacked_inbox(sem: Semiring, arrays, cfg, S: int, R_max: int,
                  gval, gchg):
    """Relax + dense exchange on the stacked layout: one reduced global
    inbox.  Returns the ((S, R_max) inbox, message count)."""
    check_ported(cfg)
    flat, counts = stacked_dense_inbox(sem, arrays, cfg, gval, gchg,
                                       S * R_max)
    return flat.reshape(S, R_max), counts


def stacked_collapse(sem: Semiring, arrays, cfg, table):
    """Eager rhizome collapse of a stacked (S, R_max) table: the dense
    sibling collapse."""
    check_ported(cfg)
    return collapse(sem, _flat(table), arrays.sibling_flat,
                    arrays.sibling_mask)


def fixpoint_round_stacked(sem: Semiring, arrays, cfg, S: int, R_max: int,
                           val, chg):
    """One stacked fixpoint round: relax → exchange → combine → eager
    rhizome collapse → predicate.  ``val``/``chg``: (S, R_max).  Returns
    (new val, new changed, message count)."""
    inbox, counts = stacked_inbox(sem, arrays, cfg, S, R_max, _flat(val),
                                  _flat(chg))
    cand = sem.combine(val, inbox)
    if cfg.collapse == "eager":
        cand = stacked_collapse(sem, arrays, cfg, cand)
    new_chg = sem.improved(cand, val) & arrays.slot_valid
    return cand, new_chg, counts


# --------------------------------------------------------------------------
# host-side accounting mirrors (flight-recorder feeds)
# --------------------------------------------------------------------------

def shard_message_mirror(edge_mask, edge_src_root_flat, gchg):
    """Per-shard message-volume mirror: how many live edge messages each
    shard's edge list delivers this round — ``edge_mask & frontier[src]``
    summed per shard, exactly the population ``relax`` counts (so the
    vector sums to the round's kernel-side message count).  Host-side
    numpy over the (S, E_max) partition arrays; feeds the flight
    recorder's per-shard skew/balance gauge."""
    mask = np.asarray(edge_mask)
    srcs = np.asarray(edge_src_root_flat)
    g = np.asarray(gchg).reshape(-1)
    return (mask & g[srcs]).sum(axis=tuple(range(1, mask.ndim)))
