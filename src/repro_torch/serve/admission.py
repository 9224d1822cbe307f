"""Admission-control layer of the serving loop (standard library only).

The paper's runtime makes congestion control a first-class design knob —
the CCA-Simulator exposes ``THROTTLE``, ``THROTTLE_CONGESTION_THRESHOLD``,
``ACTIONQUEUESIZE`` and ``DIFFUSE_QUEUE_SIZE`` because a fine-grain
message-driven system collapses when work is admitted faster than cells
can drain it.  This module is the serving-side analog, used by the
graph ``QueryServer`` (``query.server``):

* ``AdmissionQueue`` — a bounded queue (``max_queue`` is the
  ACTIONQUEUESIZE analog) with a configurable overload policy:
  ``'block'`` (the submitter ticks the server until space frees — the
  THROTTLE cool-down), ``'reject'`` (typed rejection, no exception), or
  ``'shed'`` (evict the lowest-priority queued request to make room for
  a more urgent one).  Dequeue order is priority-first, then weighted
  per-tenant fairness (lowest lanes-in-use ÷ weight first, so no tenant
  is starved of its share), then FIFO — with one tenant and equal
  priorities this is exactly FIFO, keeping the non-overloaded serving
  path trace-identical to the unpoliced server.
* ``ResultCache`` — an LRU root-keyed result cache with a staleness
  bound, for the highly repetitive top-k PPR / BFS recommendation
  traffic.
* ``FaultPlan`` — deterministic fault injection (induced lane failure,
  delayed tick) so tests and the load harness can prove every failure
  path surfaces as a typed ``QueryResult`` status rather than an
  exception out of the serving loop.

Every overload outcome is a ``QueryStatus`` string on the result, never
an exception: the serving loop must degrade, not fall over.
"""
from __future__ import annotations

import collections
import dataclasses
import typing


class QueryStatus:
    """Typed terminal statuses a request can resolve to.  ``OK`` is the
    only status with a complete (non-partial) result; everything else is
    an overload / robustness outcome that the serving loop reports
    instead of raising."""

    OK = "ok"
    REJECTED = "rejected"              # bounded queue, policy='reject'
    SHED = "shed"                      # dropped by the shed policy
    DEADLINE_EXPIRED = "deadline_expired"  # SLO passed; partial values
    TIMEOUT = "timeout"                # wall-clock execution cap hit
    BUDGET_EXHAUSTED = "budget_exhausted"  # round budget hit; partial
    FAILED = "lane_failed"             # injected / detected lane failure
    RECOVERED = "recovered"            # completed after checkpoint restore
    DEGRADED = "degraded"              # recovery exhausted; partial values

    TERMINAL = frozenset((OK, REJECTED, SHED, DEADLINE_EXPIRED, TIMEOUT,
                          BUDGET_EXHAUSTED, FAILED, RECOVERED, DEGRADED))
    # statuses that still carry (partial) values — RECOVERED is not here
    # because it carries a *complete* result (like OK, after a restore)
    PARTIAL_VALUED = frozenset((DEADLINE_EXPIRED, TIMEOUT,
                                BUDGET_EXHAUSTED, DEGRADED))


class QueryValidationError(ValueError):
    """A request rejected at submit time (unknown kind, out-of-range or
    empty sources, NaN/negative damping, negative budgets) — typed so
    callers can distinguish bad input from overload outcomes."""


class AdmissionError(RuntimeError):
    """The 'block' policy could not make progress (queue full and the
    serving loop cannot drain — e.g. zero lanes for every queued kind)."""


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault-injection schedule, keyed on the server tick.

    ``lane_failures``: (tick, pool, lane) triples — at the start of that
    tick the occupied lane is killed; its request resolves with status
    ``QueryStatus.FAILED`` (values lost).  ``pool`` is ``'min'`` or
    ``'ppr'``.
    ``tick_delays``: (tick, seconds) pairs — the server's clock is
    advanced by ``seconds`` at that tick (a stalled tick), so wall-clock
    deadlines and timeouts fire exactly as they would under a real stall,
    without sleeping in tests.
    """

    lane_failures: tuple = ()
    tick_delays: tuple = ()

    def failures_at(self, tick: int):
        return [(pool, lane) for t, pool, lane in self.lane_failures
                if t == tick]

    def delay_at(self, tick: int) -> float:
        return float(sum(s for t, s in self.tick_delays if t == tick))


@dataclasses.dataclass
class ServeConfig:
    """Robustness knobs for a serving loop (the CCA-Simulator congestion
    knobs, serving-side).  The defaults — unbounded queue, no cache, no
    faults — reproduce the unpoliced server trace-identically.

    max_queue: bounded admission queue length (ACTIONQUEUESIZE analog);
        None = unbounded (legacy behavior).
    overload_policy: 'block' | 'reject' | 'shed' — what happens to a
        submit when the queue is full (see ``AdmissionQueue``).
    block_max_ticks: safety valve for 'block': how many server ticks a
        blocked submit may spin before raising ``AdmissionError``.
    tenant_weights: tenant id -> weighted share of lanes (missing ids
        weigh 1.0).  Fairness is deficit-based: the queued tenant with
        the lowest lanes-in-use ÷ weight is served first at equal
        priority, so a heavy tenant cannot starve a light one.
    preempt: an urgent request may preempt the lowest-priority running
        lane when no lane is free (strictly greater priority only, so
        default-priority traffic never preempts and stays
        trace-identical).  The preempted request is re-queued at its
        original FIFO position and restarts.
    cache_size: root-keyed LRU result-cache capacity; 0 disables.
    cache_ttl_s: staleness bound for cache hits (None = never stale).
    faults: optional ``FaultPlan`` for fault injection.
    checkpoint_every: snapshot the server's lane/queue state to its
        attached ``CheckpointManager`` every K ticks (None disables —
        the default keeps the unpoliced path trace-identical).
    """

    max_queue: int | None = None
    overload_policy: str = "reject"
    block_max_ticks: int = 10000
    tenant_weights: dict = dataclasses.field(default_factory=dict)
    preempt: bool = True
    cache_size: int = 0
    cache_ttl_s: float | None = None
    faults: FaultPlan | None = None
    checkpoint_every: int | None = None

    def __post_init__(self):
        if self.overload_policy not in ("block", "reject", "shed"):
            raise ValueError(
                f"unknown overload_policy {self.overload_policy!r}: "
                "expected 'block', 'reject', or 'shed'")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None = unbounded)")
        if self.checkpoint_every is not None and self.checkpoint_every < 1:
            raise ValueError(
                "checkpoint_every must be >= 1 (or None = disabled)")


class _Entry(typing.NamedTuple):
    seq: int
    priority: int
    tenant: str
    item: object


class AdmissionQueue:
    """Bounded priority/tenant-fair admission queue.

    ``offer`` applies the overload policy; ``take`` pops the next
    admissible item under (priority desc, tenant deficit asc, FIFO)
    ordering.  With one tenant and uniform priorities the order is
    exactly FIFO — the non-overloaded path stays trace-identical to a
    plain list queue."""

    def __init__(self, max_queue: int | None = None,
                 policy: str = "reject", tenant_weights: dict | None = None):
        self.max_queue = max_queue
        self.policy = policy
        self.tenant_weights = dict(tenant_weights or {})
        self._entries: list[_Entry] = []
        self._seq = 0

    # ------------------------------------------------------------ plumbing
    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return (e.item for e in self._entries)

    def __eq__(self, other):
        if isinstance(other, AdmissionQueue):
            return self._entries == other._entries
        if isinstance(other, (list, tuple)):
            return [e.item for e in self._entries] == list(other)
        return NotImplemented

    @property
    def full(self) -> bool:
        return (self.max_queue is not None
                and len(self._entries) >= self.max_queue)

    @property
    def next_seq(self) -> int:
        """The seq the next plain push will get (recorded by the server
        so a preempted request can re-queue at its original position)."""
        return self._seq

    def remove(self, entry: _Entry):
        """Remove a specific entry previously returned by ``peek``."""
        self._entries.remove(entry)

    # ------------------------------------------------------------- enqueue
    def offer(self, item, priority: int | None = None,
              tenant: str | None = None):
        """Apply the overload policy.  Returns (decision, victim):

        decision: 'admitted' | 'rejected' | 'shed_incoming' | 'blocked';
        victim: a previously queued item evicted by the shed policy (its
        owner must resolve it with status SHED), else None.  'blocked'
        means the caller should drain the loop and re-offer."""
        priority = (getattr(item, "priority", 0) if priority is None
                    else priority)
        tenant = (getattr(item, "tenant", "default") if tenant is None
                  else tenant)
        if not self.full:
            self._push(item, priority, tenant)
            return "admitted", None
        if self.policy == "block":
            return "blocked", None
        if self.policy == "reject":
            return "rejected", None
        # shed: evict the lowest-priority queued entry (newest among
        # equals, preserving FIFO fairness for the older ones) iff the
        # incoming request outranks it; else the incoming one is shed
        victim = max(self._entries, key=lambda e: (-e.priority, e.seq))
        if priority > victim.priority:
            self._entries.remove(victim)
            self._push(item, priority, tenant)
            return "admitted", victim.item
        return "shed_incoming", None

    def _push(self, item, priority, tenant, seq: int | None = None):
        if seq is None:
            seq, self._seq = self._seq, self._seq + 1
        self._entries.append(_Entry(seq, priority, tenant, item))

    def put_back(self, item, priority: int, tenant: str, seq: int):
        """Re-queue a preempted item at its original FIFO position.
        Returns False (caller sheds the item) when the queue is full and
        the item does not outrank any queued entry."""
        if self.full:
            victim = max(self._entries, key=lambda e: (-e.priority, e.seq))
            if priority <= victim.priority:
                return False
            self._entries.remove(victim)
            # the displaced entry is genuinely lower priority: it is shed
            self._push(item, priority, tenant, seq)
            return victim.item
        self._push(item, priority, tenant, seq)
        return True

    # ------------------------------------------------------------- dequeue
    def _order_key(self, in_flight):
        def key(e: _Entry):
            w = float(self.tenant_weights.get(e.tenant, 1.0))
            deficit = in_flight.get(e.tenant, 0) / max(w, 1e-9)
            return (-e.priority, deficit, e.seq)
        return key

    def peek(self, pred=None, in_flight: dict | None = None):
        """Best queued entry admissible under ``pred`` (or None)."""
        cands = [e for e in self._entries
                 if pred is None or pred(e.item)]
        if not cands:
            return None
        return min(cands, key=self._order_key(in_flight or {}))

    def take(self, pred=None, in_flight: dict | None = None):
        """Pop and return the best admissible entry (or None)."""
        e = self.peek(pred, in_flight)
        if e is not None:
            self._entries.remove(e)
        return e

    def drain_if(self, pred):
        """Remove and return all queued items matching ``pred`` (e.g.
        queued-deadline expiry)."""
        out = [e for e in self._entries if pred(e.item)]
        for e in out:
            self._entries.remove(e)
        return [e.item for e in out]


class ResultCache:
    """Root-keyed LRU result cache with a staleness bound.

    Keys are canonicalized (kind, sources[, damping, tol]) tuples built
    by the server; values are whatever payload the server stores.  A hit
    older than ``ttl_s`` is evicted, never served stale."""

    def __init__(self, size: int, ttl_s: float | None = None):
        self.size = int(size)
        self.ttl_s = ttl_s
        self._d: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def __len__(self):
        return len(self._d)

    def get(self, key, now: float):
        if self.size <= 0:
            return None
        hit = self._d.get(key)
        if hit is not None:
            payload, stored_at = hit
            if self.ttl_s is not None and now - stored_at > self.ttl_s:
                del self._d[key]            # stale: drop, count as miss
            else:
                self._d.move_to_end(key)
                self.hits += 1
                return payload
        self.misses += 1
        return None

    def put(self, key, payload, now: float):
        if self.size <= 0:
            return
        self._d[key] = (payload, now)
        self._d.move_to_end(key)
        while len(self._d) > self.size:
            self._d.popitem(last=False)

    @staticmethod
    def _key_vertices(key):
        """Vertex ids a canonical cache key depends on: the sources
        element holds ints (min-pool) or (vertex, value) pairs (dict
        sources / ppr seeds)."""
        for item in key[1]:
            yield item[0] if isinstance(item, tuple) else item

    def invalidate(self, root: int) -> int:
        """Drop every cached result whose source set touches ``root`` —
        the hook streaming-graph mutation needs: an edge change at a
        vertex stales exactly the queries rooted there.  Returns the
        number of entries dropped (also tallied in ``invalidations``)."""
        root = int(root)
        doomed = [k for k in self._d if root in self._key_vertices(k)]
        for k in doomed:
            del self._d[k]
        self.invalidations += len(doomed)
        return len(doomed)

    def invalidate_all(self) -> int:
        """Flush the cache (whole-graph mutation); returns entries dropped."""
        n = len(self._d)
        self._d.clear()
        self.invalidations += n
        return n
