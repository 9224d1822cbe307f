"""Recompute roofline terms from cached .trace.json.gz files (no tracing).

  PYTHONPATH=src python -m repro_torch.lm.launch.reanalyze

Each record's ``per_device``, ``collectives``, ``roofline`` and
``useful_compute_ratio`` are recomputed from its per-op trace summary
with ``dryrun``'s constants (``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW``):
the same figures ``run_cell`` wrote, or new ones after a change of the
constants or of the summing.
"""
import glob
import gzip
import json
import os

from repro_torch.lm.launch import dryrun
from repro_torch.lm.launch.dryrun import RESULTS_DIR


def reanalyze(rec: dict, trace_path: str) -> dict:
    """``rec`` with its analysed fields recomputed from the trace
    summary at ``trace_path`` (a new dict)."""
    with gzip.open(trace_path, "rt") as zf:
        summary = json.load(zf)
    out = dict(rec)
    dryrun.analyze_into(out, summary)
    return out


def main(results_dir: str = RESULTS_DIR):
    for jpath in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        tpath = jpath.replace(".json", ".trace.json.gz")
        if not os.path.exists(tpath):
            continue
        with open(jpath) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            continue
        rec = reanalyze(rec, tpath)
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        print(os.path.basename(jpath), "reanalyzed")


if __name__ == "__main__":
    main()
