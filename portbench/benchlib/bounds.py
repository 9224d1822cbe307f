"""The yardstick's arithmetic: Graph500's TEPS count and the least bytes
each call needs at the H100's memory rate, counted from the graph and
the reference's searches, never from the program's layout.

Every count is of what any implementation must move at least once: an
edge's destination id (and weight, where the relax reads it) for each
edge out of a reached vertex, each reached vertex's offsets, value read
and value written, and the result vector written.  PageRank reads every
edge and every vertex each iteration.  A laned server runs up to ``lanes``
queries in one round, so a query pays a ``lanes``-th of the edges and
offsets it reads (the lanes may share them) and all of its own values.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM5 80 GB HBM3, data sheet
ID = 4                      # int32 vertex id or offset
VAL = 4                     # float32 value


def search_bytes(n: int, reached: int, edges: int, weighted: bool,
                 lanes: int = 1) -> float:
    """Least bytes of one BFS / SSSP / reachability search."""
    shared = edges * (ID + (VAL if weighted else 0)) + reached * 2 * ID
    own = reached * 2 * VAL + n * VAL
    return shared / lanes + own


def pagerank_bytes(n: int, num_edges: int, iters: int) -> float:
    """Least bytes of ``iters`` PageRank iterations: per iteration each
    edge's id, each vertex's offsets, out-degree, score read and score
    written."""
    return iters * (num_edges * ID + n * (2 * ID + ID + 2 * VAL))


def bound_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
