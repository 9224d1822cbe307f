"""Find a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names the cells, their
configuration and traffic, and the metrics.  Everything else is a file
of its own under the benchmark's folder, found by name, so a later cell,
configuration, traffic mix or metric is added as files and entries only:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<name>.json``, the parameters of the mix;
  its ``driver`` names the module ``drivers/<driver>.py`` that runs it
  (``run(r, graph)`` and ``CONTROLS``, the controls it can put in the
  program's place), so a traffic of a new shape is a new file too;
- a metric: ``metrics/<name>.py``, else ``metrics/<stem>.py`` where the
  stem is the name before its first dot (``device_idle_pct.serve`` reads
  with ``metrics/device_idle_pct.py``); the module's ``read(facts)``
  returns the number, or ``None`` where the run has nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: object            # read(facts: dict) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list           # [Metric]: end-to-end (trace 0) or per-layer
    driver: object          # the traffic's drivers/<driver>.py module


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _module(bench_dir: pathlib.Path, sub: str, stem: str):
    """The module ``<sub>/<stem>.py`` under the benchmark's folder, or
    ``None`` where there is no such file."""
    path = bench_dir / sub / f"{stem}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(
        f"portbench_{sub}_{stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(bench_dir: pathlib.Path, name: str):
    """``read`` of ``metrics/<name>.py``, else of ``metrics/<stem>.py``."""
    for stem in (name, name.split(".")[0]):
        mod = _module(bench_dir, "metrics", stem)
        if mod is not None:
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{bench_dir / 'metrics'}")


def load_driver(bench_dir: pathlib.Path, name: str):
    """The traffic driver ``drivers/<name>.py``."""
    mod = _module(bench_dir, "drivers", name)
    if mod is None:
        raise FileNotFoundError(f"no traffic driver {name!r} under "
                                f"{bench_dir / 'drivers'}")
    return mod


def load_cell(root: pathlib.Path, bench_dir: pathlib.Path, name: str,
              trace: bool) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic and the readers of the metrics it reports (per-layer ones
    when ``trace``)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    entries = bench["per_layer" if trace else "end_to_end"]
    metrics = [Metric(m["name"], m["unit"], load_reader(bench_dir, m["name"]))
               for m in entries if _applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, metrics,
                load_driver(bench_dir, traffic["driver"]))
