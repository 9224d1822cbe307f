"""Small statistics the harness and its metrics share."""
from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """Nearest-rank percentile over every value: the smallest value with at
    least ``q`` percent of all values at or below it.  A request that
    failed enters as ``inf``, so a tail with failures in it reads
    ``inf``.  Empty input reads ``nan``."""
    vals = sorted(values)
    if not vals:
        return math.nan
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return float(vals[rank - 1])


class Reservoir:
    """A uniform sample of at most ``k`` items from a stream of unknown
    length, drawn from ``seed`` (Vitter's algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
