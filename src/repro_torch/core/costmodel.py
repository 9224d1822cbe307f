"""Analytic AM-CCA cost model for large graphs (paper Figs 7–10), on
tensors.

Replays a reference execution trace (per-round active vertices from
``repro_torch.graph.reference``) against a Partition and estimates,
without simulating individual cycles:

* per-round message counts (diffusions + rhizome sibling broadcasts +
  root→ghost relays),
* per-link loads under XY dimension-order routing (difference arrays over
  row/column link segments → Fig 9 contention histograms),
* time-to-solution ≈ Σ_rounds max(serialization bounds): peak link load,
  peak CC injection, peak CC arrival, mean distance,
* energy per the §6.1 model (hop/action/SRAM/leakage terms; torus hops
  cost 1.5×).

A round's messages are gathered on the model's device (a CSR gather over
the active vertices' out-edges, in trace order) and counted in int64, so
every count is exact; the host reads a few totals a round.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.amcca_sim import (
    E_ACTION_PJ, E_HOP_PJ, E_LEAK_PJ_PER_CC_CYCLE, E_SRAM_PJ, TORUS_HOP_FACTOR,
    csr_gather,
)
from repro_torch.core.engine import resolve_device
from repro_torch.core.partition import Partition


@dataclasses.dataclass
class CostResult:
    cycles: float
    energy_pj: float
    messages: int
    hops: int
    rounds: int
    max_link_load: int
    link_loads: torch.Tensor    # (num_h_links + num_v_links,) int64
    cc_arrivals: torch.Tensor   # (S,) int64
    per_round_cycles: list


class CostModel:
    def __init__(self, part: Partition, torus: bool = True, device=None):
        self.part = part
        self.device = dev = resolve_device(device)
        self.X, self.Y = part.cfg.dims()
        self.torus = torus
        self.S = part.S
        R_max = part.R_max

        def put(x, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev
                                   ).to(dtype)

        mask = put(part.edge_mask.reshape(-1), torch.bool)
        e_src = put(part.edge_src_vertex.reshape(-1))[mask]
        order = torch.argsort(e_src, stable=True)
        self.e_src = e_src[order]
        self.e_owner = put(part.edge_owner_cc.reshape(-1))[mask][order]
        self.e_dst_cc = (put(part.edge_dst_flat.reshape(-1))[mask]
                         // R_max)[order]
        self.v_ptr = torch.zeros(part.n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(torch.bincount(self.e_src, minlength=part.n), 0,
                     out=self.v_ptr[1:])

        # per-vertex rhizome fan (sibling shards) and root cc
        root_flat = put(part.root_flat)
        self.root_cc = root_flat // R_max
        self.num_replicas = put(part.num_replicas)
        sib_sh = torch.where(put(part.sibling_mask, torch.bool),
                             put(part.sibling_flat) // R_max, -1)
        # (n, K): the sibling shards of each vertex's root slot
        self.root_sib_shards = sib_sh.reshape(-1, sib_sh.shape[-1])[root_flat]

    # ----- geometry -------------------------------------------------------
    def _xy(self, cc):
        return cc % self.X, cc // self.X

    def dist(self, a, b):
        ax, ay = self._xy(a)
        bx, by = self._xy(b)
        dx, dy = (ax - bx).abs(), (ay - by).abs()
        if self.torus:
            dx = torch.minimum(dx, self.X - dx)
            dy = torch.minimum(dy, self.Y - dy)
        return dx + dy

    def _segments(self, s, d, n):
        """Difference-array updates of the links between ``s`` and ``d``
        along one axis of length ``n``: (start, stop, sign) per update,
        link i = (i -> i+1); a segment that wraps on the torus is the two
        runs [hi, n) and [0, lo), each update weighted by whether it
        applies (0 or ±1), so no update needs a mask."""
        if self.torus:
            fwd = ((d - s) % n) <= ((s - d) % n)
            lo = torch.where(fwd, s, d)
            hi = torch.where(fwd, d, s)
            wrap = torch.where(fwd, (d - s) % n, (s - d) % n) != (hi - lo)
        else:
            lo, hi = torch.minimum(s, d), torch.maximum(s, d)
            wrap = torch.zeros_like(s, dtype=torch.bool)
        nw, w = (~wrap).to(torch.int64), wrap.to(torch.int64)
        pos = torch.cat([lo, hi, hi, torch.full_like(s, n),
                         torch.zeros_like(s), lo])
        val = torch.cat([nw, -nw, w, -w, w, -w])
        return pos, val

    def _accumulate_links(self, src_cc, dst_cc, h_diff, v_diff):
        """XY routing: horizontal segment in the source row, then vertical
        segment in the destination column — O(msgs) difference updates."""
        sx, sy = self._xy(src_cc)
        dx, dy = self._xy(dst_cc)
        for diff, row, s, d, n in ((h_diff, sy, sx, dx, self.X),
                                   (v_diff, dx, sy, dy, self.Y)):
            pos, val = self._segments(s, d, n)
            diff.view(-1).index_add_(0, row.repeat(6) * (n + 1) + pos, val)

    # ----- replay ---------------------------------------------------------
    def replay(self, trace: list) -> CostResult:
        dev = self.device
        h_diff = torch.zeros((self.Y, self.X + 1), dtype=torch.int64,
                             device=dev)
        v_diff = torch.zeros((self.X, self.Y + 1), dtype=torch.int64,
                             device=dev)
        cc_arr = torch.zeros(self.S, dtype=torch.int64, device=dev)
        msgs = hops = 0
        per_round = []
        actions = 0
        for f in trace:
            f = torch.as_tensor(np.asarray(f), device=dev).to(torch.int64)
            if f.numel() == 0:
                continue
            # out-edge diffusions of the active vertices
            eidx, _ = csr_gather(self.v_ptr, f)
            src_cc = self.e_owner[eidx]
            dst_cc = self.e_dst_cc[eidx]
            # root -> ghost relay messages
            relay_src = self.root_cc[self.e_src[eidx]]
            relay_dst = src_cc
            # rhizome sibling broadcasts: root -> each sibling replica
            # shard other than the root's, at most fan of them, row-major
            r_cc = self.root_cc[f]
            fan = (self.num_replicas[f] - 1).clamp_min(0)
            sib = self.root_sib_shards[f]
            other = (sib >= 0) & (sib != r_cc[:, None])
            take = other & (torch.cumsum(other.to(torch.int64), 1)
                            <= fan[:, None])
            bc_dst = sib[take]
            # the sources are the roots repeated fan times, cut to the
            # destinations' count (a root with fewer sibling shards than
            # its fan shifts the later pairs, as in the reference)
            bc_src = torch.repeat_interleave(r_cc, fan)[:bc_dst.numel()]

            all_src = torch.cat([src_cc, relay_src, bc_src])
            all_dst = torch.cat([dst_cc, relay_dst, bc_dst])
            d = self.dist(all_src, all_dst)
            self._accumulate_links(all_src, all_dst, h_diff, v_diff)
            cc_arr.index_add_(0, all_dst, torch.ones_like(all_dst))
            loads = torch.stack([
                torch.bincount(all_src, minlength=self.S).max(),
                torch.bincount(all_dst, minlength=self.S).max(),
                d.sum()]).tolist()
            n_msg = all_src.numel()
            msgs += n_msg
            hops += loads[2]
            actions += eidx.numel()
            # round time: serialization bound (one msg/link/cycle, one
            # injection/CC/cycle, one action/CC/cycle) + pipeline latency;
            # the mean distance is the exact integer sum over the count
            per_round.append(float(max(loads[0], loads[1])
                                   + (loads[2] / n_msg if n_msg else 0.0)))

        h_loads = torch.cumsum(h_diff[:, :-1], 1).reshape(-1)
        v_loads = torch.cumsum(v_diff[:, :-1], 1).reshape(-1)
        link_loads = torch.cat([h_loads, v_loads])
        max_link = int(link_loads.max()) if link_loads.numel() else 0
        # congestion bound over the whole run (links are reused across
        # rounds; the max-link serialization applies globally)
        cycles = max(float(max_link), sum(per_round))
        hop_e = E_HOP_PJ * (TORUS_HOP_FACTOR if self.torus else 1.0)
        energy = (hops * hop_e + actions * (E_ACTION_PJ + 2 * E_SRAM_PJ)
                  + cycles * self.S * E_LEAK_PJ_PER_CC_CYCLE)
        return CostResult(
            cycles=cycles, energy_pj=float(energy), messages=msgs, hops=hops,
            rounds=len(per_round), max_link_load=max_link,
            link_loads=link_loads, cc_arrivals=cc_arr,
            per_round_cycles=per_round,
        )
