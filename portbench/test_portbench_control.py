"""``correct`` on the CPU at a tiny size: true for the program, false for
each cell's control in the program's place, and false for each fault
planted underneath the timed path.  The chip's readings come from
``control.py`` at the cells' own sizes."""
import copy
import pathlib
import time

import numpy as np
import pytest
import torch

from benchlib import check, spec, traffic

HERE = pathlib.Path(__file__).parent
CELLS = ["parmat-s22-traversal", "parmat-s22-serve", "graph500-s22-pagerank"]
CONTROL = {"parmat-s22-traversal": "stale", "parmat-s22-serve": "stale",
           "graph500-s22-pagerank": "bf16"}


def tiny(name, seed=2**31 + 99, controls=()):
    """The cell's run at scale 7 on the CPU (the port's torch relax, since
    its CUDA kernels need the card); returns (correct of the program,
    correct of each control, facts)."""
    cell = spec.load_cell(HERE.parent, HERE, name, trace=False)
    cfg = dict(cell.config, scale=7,
               partition={"num_shards": 4, "rpvo_max": 4})
    t = copy.deepcopy(cell.traffic)
    t["engine"]["use_pallas"] = False
    if "root_pool" in t:
        t["root_pool"] = 8
    if t["driver"] == "serve":
        t.update(server=dict(t["server"], n_lanes=4), clients=8)
        cell.driver.DRAIN_S = 0.5     # answers that never come: fail fast
    facts, readings = traffic.run(traffic.Run(
        cfg, t, cell.driver, seed, 0.15, False, torch.device("cpu"),
        time.perf_counter(), controls=controls))
    verdicts = {who: check.verdict(rd, t["limits"])[0]
                for who, rd in readings.items()}
    return verdicts, facts


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct_and_its_control_is_not(name):
    verdicts, facts = tiny(name, controls=(CONTROL[name],))
    assert verdicts[None] is True
    assert verdicts[CONTROL[name]] is False
    assert facts["attempted"] > 0 and facts["failed"] == 0


def _unchanged(monkeypatch, name):
    from repro_torch.core import engine
    from repro_torch.query import server
    if name == "parmat-s22-traversal":
        run = engine.run_stacked

        def same(sem, part, init_val, *a, **k):
            val, stats = run(sem, part, init_val, *a, **k)
            return torch.as_tensor(init_val).to(val), stats
        monkeypatch.setattr(engine, "run_stacked", same)
    elif name == "graph500-s22-pagerank":
        run = engine.run_pagerank_stacked
        monkeypatch.setattr(engine, "run_pagerank_stacked",
                            lambda part, d, iters, *a, **k:
                            run(part, d, 0, *a, **k))
    else:
        monkeypatch.setattr(
            server._MinPool, "step",
            lambda self: torch.zeros(self.n, dtype=torch.int64,
                                     device=self.dev))


def _half(monkeypatch, name):
    from repro_torch.core import engine
    from repro_torch.query import server
    if name == "parmat-s22-traversal":
        run, last, calls = engine.run_stacked, {}, [0]

        def every_other(*a, **k):            # half the calls not made
            calls[0] += 1
            if calls[0] % 2 == 0 and last:
                return last["out"]
            last["out"] = run(*a, **k)
            return last["out"]
        monkeypatch.setattr(engine, "run_stacked", every_other)
    elif name == "graph500-s22-pagerank":
        from repro_torch import exchange
        rnd = exchange.pagerank_round_stacked

        def half_diffuse(sem, arrays, cfg, S, R_max, base, d, val, chg,
                         *a, **k):               # half the slots send nothing
            keep = torch.arange(chg.numel(), device=chg.device) % 2 == 0
            return rnd(sem, arrays, cfg, S, R_max, base, d, val,
                       chg & keep.reshape(chg.shape), *a, **k)
        monkeypatch.setattr(exchange, "pagerank_round_stacked", half_diffuse)
    else:
        retire = server.QueryServer._retire

        def drop_odd(self, pool, lane, status, partial):
            qid = pool.reqs[lane].qid
            retire(self, pool, lane, status, partial)
            if qid % 2:                          # half the answers never come
                self.results.pop(qid, None)
        monkeypatch.setattr(server.QueryServer, "_retire", drop_odd)


def _altered(monkeypatch, name):
    from repro_torch.core import engine
    values = engine.vertex_values

    def one_off(part, val):
        out = np.array(values(part, val))
        finite = np.flatnonzero(np.isfinite(out))
        if finite.size:
            out[finite[-1]] += 1
        return out
    monkeypatch.setattr(engine, "vertex_values", one_off)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch, name)
    verdicts, _ = tiny(name)
    assert verdicts[None] is False
