"""Vectorized cycle-level AM-CCA simulator (paper §6.1 methodology), on
tensors.

Models a chip of X×Y compute cells on a Mesh or Torus-Mesh NoC:

* one message traverses one hop per cycle (256-bit channels, single-flit
  messages), XY dimension-order routing, one message per (CC, direction)
  per cycle — extra claimants stall and are counted as *contention*;
* per-CC injection of one staged message per cycle (a CC either computes
  or stages a message);
* **throttling** (Eq. 2): a CC that saw contention on its links halts
  injection for ``T = hypot(dim_x, dim_y)`` cycles (halved on torus);
* **dual queues / lazy diffuse**: staged diffusions carry their own
  predicate and are re-checked at injection time — stale diffusions are
  pruned (Fig 6);
* rhizome-link sibling broadcasts and root→ghost relay latency are
  modeled as messages / injection delays.

Supports min-semiring applications (BFS, SSSP).  Every per-cycle array
is a tensor on the simulator's device (int64 and float64); the staged
queue and the in-flight set are kept in queue order, which decides every
first-wins arbitration (the first ready entry per CC injects, the first
claimant per (CC, direction) hops).  The host reads a few sizes a cycle
(the compactions by ``nonzero``, the improved slots, the edges staged);
the counters stay on the device until the run ends.  The analytic model
(``repro_torch.core.costmodel``) covers large runs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.partition import Partition

# --- energy constants (7nm, paper §6.1 energy cost model; pJ) -------------
E_HOP_PJ = 15.0        # one 256-bit flit across one NoC hop (mesh)
TORUS_HOP_FACTOR = 1.5 # torus consumes 50% more NoC resources [22]
E_ACTION_PJ = 25.0     # predicate + work: few integer ops + SRAM access
E_SRAM_PJ = 6.0        # 64-bit SRAM access [31]
E_LEAK_PJ_PER_CC_CYCLE = 0.05

_PRUNE_EPS = 1e-12


@dataclasses.dataclass
class SimResult:
    cycles: int
    messages_injected: int
    hops_total: int
    actions_executed: int       # messages delivered (predicate evaluated)
    work_actions: int           # predicate fired -> work performed
    diffusions_staged: int
    diffusions_pruned: int      # pruned at injection time (lazy diffuse)
    contention_stall_cycles: int
    link_contention: torch.Tensor  # (S, 4) int64 stalls per (cc, direction)
    max_inflight: int
    energy_pj: float
    values: torch.Tensor           # (S*R_max,) float64 final slot values


def _xy_next_hop(cx, cy, dxs, dys, X, Y, torus):
    """XY routing: move in x first, then y. Returns (nx, ny, direction).
    Directions: 0=E,1=W,2=N,3=S."""
    gox = cx != dxs
    if torus:
        right = ((dxs - cx) % X) <= ((cx - dxs) % X)
        up = ((dys - cy) % Y) <= ((cy - dys) % Y)
    else:
        right = dxs > cx
        up = dys > cy
    stepx = torch.where(right, 1, -1)
    stepy = torch.where(up, 1, -1)
    nx = torch.where(gox, (cx + stepx) % X if torus else cx + stepx, cx)
    ny = torch.where(gox, cy, (cy + stepy) % Y if torus else cy + stepy)
    direction = torch.where(gox, torch.where(right, 0, 1),
                            torch.where(up, 2, 3))
    return nx, ny, direction


def csr_gather(v_ptr, vertices):
    """(edge ids, the position in ``vertices`` of each edge's vertex) of
    the out-edges of ``vertices``: each vertex's edges in ``v_ptr``
    order, vertices in the order given (repeats included)."""
    lo = v_ptr[vertices]
    deg = v_ptr[vertices + 1] - lo
    total = int(deg.sum())
    rep = torch.repeat_interleave(
        torch.arange(vertices.numel(), device=vertices.device), deg,
        output_size=total)
    start = torch.cumsum(deg, 0) - deg
    return (lo[rep] + torch.arange(total, device=vertices.device)
            - start[rep]), rep


def _first_per_key(keys, eligible, n_keys: int):
    """(n_keys,) queue position of the first eligible entry of each key,
    ``len(keys)`` where a key has none: the first-wins arbitration."""
    n = keys.numel()
    pos = torch.arange(n, device=keys.device)
    first = torch.full((n_keys,), n, dtype=torch.int64, device=keys.device)
    return first.scatter_reduce_(0, keys, torch.where(eligible, pos, n),
                                 "amin")


class AmccaSim:
    def __init__(self, part: Partition, torus: bool = True, seed: int = 0,
                 device=None):
        self.part = part
        self.device = dev = resolve_device(device)
        self.X, self.Y = part.cfg.dims()
        self.torus = torus
        self.S = part.S
        self.R_max = part.R_max
        # ``seed``: the reference's call form; the simulator draws nothing
        # Eq. 2 throttling period
        t = float(np.hypot(self.X, self.Y))
        self.throttle_T = int(np.ceil(t / 2 if torus else t))

        def put(x, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev
                                   ).to(dtype)

        # flatten edges: for each vertex, its out-edges with owner cc + dst
        mask = put(part.edge_mask.reshape(-1), torch.bool)
        e_src = put(part.edge_src_vertex.reshape(-1))[mask]
        order = torch.argsort(e_src, stable=True)
        self.e_src = e_src[order]
        self.e_dst_flat = put(part.edge_dst_flat.reshape(-1))[mask][order]
        self.e_w = put(part.edge_w.reshape(-1), torch.float64)[mask][order]
        self.e_owner = put(part.edge_owner_cc.reshape(-1))[mask][order]
        self.v_ptr = torch.zeros(part.n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(torch.bincount(self.e_src, minlength=part.n), 0,
                     out=self.v_ptr[1:])
        self.root_cc = put(part.root_flat) // self.R_max
        K = part.sibling_flat.shape[-1]
        self.slot_vertex = put(part.slot_vertex.reshape(-1))
        self.sibling_flat = put(part.sibling_flat.reshape(-1, K))
        self.sibling_mask = put(part.sibling_mask.reshape(-1, K), torch.bool)

    def _cc_xy(self, cc):
        return cc % self.X, cc // self.X

    def _dist(self, a, b):
        ax, ay = self._cc_xy(a)
        bx, by = self._cc_xy(b)
        dx = (ax - bx).abs()
        dy = (ay - by).abs()
        if self.torus:
            dx = torch.minimum(dx, self.X - dx)
            dy = torch.minimum(dy, self.Y - dy)
        return dx + dy

    def run_min_app(self, sources: dict[int, float], weights: bool,
                    max_cycles: int = 200_000, throttle: bool = True) -> SimResult:
        """BFS (weights=False: msg=val+1) or SSSP (weights=True: msg=val+w)."""
        part, dev = self.part, self.device
        S, R_max, X = self.S, self.R_max, self.X
        i64, f64 = torch.int64, torch.float64
        val = torch.full((S * R_max,), math.inf, dtype=f64, device=dev)
        best_diffused = torch.full((part.n,), math.inf, dtype=f64,
                                   device=dev)  # diffusion predicate state

        # staged outbox entries (lazy diffuse queue, one row per message):
        # ob_i = [owner cc, dst flat slot, diffusing vertex, ready cycle],
        # ob_f = [payload, level/dist at staging time]
        ob_i = torch.zeros((0, 4), dtype=i64, device=dev)
        ob_f = torch.zeros((0, 2), dtype=f64, device=dev)
        # in-flight messages: fl_i = [x, y, dst flat slot], fl_v = payload
        fl_i = torch.zeros((0, 3), dtype=i64, device=dev)
        fl_v = torch.zeros(0, dtype=f64, device=dev)

        stats = dict(inj=0, act=0, work=0, staged=0, maxfl=0)
        # counted on the device: no host read until the run ends
        dstats = torch.zeros(3, dtype=i64, device=dev)  # pruned, stall, hops
        link_cont = torch.zeros(S * 4 + 1, dtype=i64, device=dev)  # + trash
        throttle_until = torch.zeros(S, dtype=i64, device=dev)

        def stage_diffusion(vertices, vals, now):
            nonlocal ob_i, ob_f
            eidx, rep = csr_gather(self.v_ptr, vertices)
            if eidx.numel() == 0:
                return
            owners = self.e_owner[eidx]
            relay = self._dist(self.root_cc[vertices][rep], owners)
            x = vals[rep]
            msg = x + (self.e_w[eidx] if weights else 1.0)
            ob_i = torch.cat([ob_i, torch.stack(
                [owners, self.e_dst_flat[eidx], vertices[rep], now + relay],
                1)])
            ob_f = torch.cat([ob_f, torch.stack([msg, x], 1)])
            stats["staged"] += eidx.numel()

        # germinate: sources' root slots perform work and diffuse
        for v, x in sources.items():
            s0, sl0 = divmod(int(part.root_flat[v]), R_max)
            for k in range(part.cfg.rpvo_max):
                if part.sibling_mask[s0, sl0, k]:
                    val[int(part.sibling_flat[s0, sl0, k])] = x
            best_diffused[v] = x
            stage_diffusion(torch.tensor([v], dtype=i64, device=dev),
                            torch.tensor([x], dtype=f64, device=dev), now=0)

        cycle = 0
        while cycle < max_cycles and (fl_i.shape[0] or ob_i.shape[0]):
            cycle += 1
            # ---- injection: one staged message per CC per cycle ----------
            n_ob = ob_i.shape[0]
            if n_ob:
                cc = ob_i[:, 0]
                # lazy-diffuse pruning: drop stale diffusions (Listing 6)
                live = ob_f[:, 1] <= best_diffused[ob_i[:, 2]] + _PRUNE_EPS
                dstats[0] += (~live).sum()
                ready = live & (ob_i[:, 3] <= cycle)
                if throttle:
                    ready &= throttle_until[cc] <= cycle
                # first ready entry per CC wins, injected in CC order
                first = _first_per_key(cc, ready, S)
                take = first[first < n_ob]
                if take.numel():
                    t_cc = cc[take]
                    # messages to slots on the same CC are delivered locally
                    fl_i = torch.cat([fl_i, torch.stack(
                        [t_cc % X, t_cc // X, ob_i[take, 1]], 1)])
                    fl_v = torch.cat([fl_v, ob_f[take, 0]])
                    stats["inj"] += take.numel()
                    live[take] = False
                keep = live.nonzero().squeeze(1)
                ob_i, ob_f = ob_i[keep], ob_f[keep]

            stats["maxfl"] = max(stats["maxfl"], fl_i.shape[0])

            # ---- network hop: one message per (cc, direction) ------------
            if fl_i.shape[0]:
                fx, fy, fdst = fl_i.unbind(1)
                dcc = fdst // R_max
                dxs, dys = dcc % X, dcc // X
                at_dst = (fx == dxs) & (fy == dys)
                move = ~at_dst
                nx, ny, ddir = _xy_next_hop(fx, fy, dxs, dys,
                                            X, self.Y, self.torus)
                cur_cc = fy * X + fx
                key = torch.where(move, cur_cc * 4 + ddir, S * 4)
                first = _first_per_key(key, move, S * 4 + 1)
                win = move & (first[key] == torch.arange(key.numel(),
                                                         device=dev))
                stalled = move & ~win
                dstats[1] += stalled.sum()
                link_cont.index_add_(0, torch.where(stalled, key, S * 4),
                                     stalled.to(i64))
                # mark CCs with contended links for throttling
                if throttle:
                    hit = torch.zeros(S + 1, dtype=i64, device=dev)
                    hit.index_add_(0, torch.where(stalled, cur_cc, S),
                                   stalled.to(i64))
                    throttle_until = torch.where(
                        hit[:S] > 0, cycle + self.throttle_T, throttle_until)
                fl_i = torch.stack([torch.where(win, nx, fx),
                                    torch.where(win, ny, fy), fdst], 1)
                dstats[2] += win.sum()

                # ---- arrivals: predicate + work + diffuse -----------------
                arr = at_dst.nonzero().squeeze(1)
                if arr.numel():
                    slots = fdst[arr]
                    vals = fl_v[arr]
                    stats["act"] += arr.numel()
                    old = val[slots]
                    val.scatter_reduce_(0, slots, vals, "amin")
                    improved = torch.unique(slots[vals < old])
                    stats["work"] += improved.numel()
                    if improved.numel():
                        verts = self.slot_vertex[improved]
                        newv = val[improved]
                        # rhizome-link sibling broadcast (collapse bcast),
                        # row-major over (improved slot, sibling)
                        sib = self.sibling_flat[improved]
                        rows, cols = (self.sibling_mask[improved]
                                      & (sib != improved[:, None])
                                      ).nonzero(as_tuple=True)
                        bvals = newv[rows]
                        ob_i = torch.cat([ob_i, torch.stack(
                            [improved[rows] // R_max, sib[rows, cols],
                             verts[rows], torch.full_like(rows, cycle)], 1)])
                        ob_f = torch.cat([ob_f, torch.stack([bvals, bvals],
                                                            1)])
                        # diffuse along out-edges, gated by best_diffused
                        gate = (newv < best_diffused[verts] - _PRUNE_EPS
                                ).nonzero().squeeze(1)
                        dverts, dvals = verts[gate], newv[gate]
                        # a vertex listed twice keeps its last value, as a
                        # fancy-index assignment does
                        pos = torch.arange(dverts.numel(), device=dev)
                        last = torch.full((part.n,), -1, dtype=i64,
                                          device=dev).scatter_reduce_(
                            0, dverts, pos, "amax")
                        best_diffused.scatter_reduce_(
                            0, dverts, torch.where(last[dverts] == pos,
                                                   dvals, math.inf), "amin")
                        stage_diffusion(dverts, dvals, now=cycle)
                    stay = move.nonzero().squeeze(1)
                    fl_i, fl_v = fl_i[stay], fl_v[stay]

        pruned, stall, hops = dstats.tolist()
        hop_e = E_HOP_PJ * (TORUS_HOP_FACTOR if self.torus else 1.0)
        energy = (hops * hop_e
                  + stats["act"] * (E_ACTION_PJ + 2 * E_SRAM_PJ)
                  + cycle * self.S * E_LEAK_PJ_PER_CC_CYCLE)
        return SimResult(
            cycles=cycle, messages_injected=stats["inj"],
            hops_total=hops, actions_executed=stats["act"],
            work_actions=stats["work"], diffusions_staged=stats["staged"],
            diffusions_pruned=pruned,
            contention_stall_cycles=stall,
            link_contention=link_cont[:S * 4].view(S, 4),
            max_inflight=stats["maxfl"],
            energy_pj=float(energy), values=val,
        )
