"""The port's parent-tree searches as the harness reaches them: whether
the port has them, its ``obs`` module (for the span recorder of traced
runs) and its ``tree_*`` counters.  The searches themselves go through
``port.search`` by name.  This file and ``port.py`` are the harness's
only importers of the port; the reference imports nothing from either.
"""
from __future__ import annotations

APPS = ("bfs_tree", "sssp_tree")


def require_trees() -> None:
    """Exit non-zero where the port has no ``apps.bfs_tree`` /
    ``apps.sssp_tree``."""
    from repro_torch import apps
    missing = [a for a in APPS if not hasattr(apps, a)]
    if missing:
        raise SystemExit(f"portbench: the port has no apps.{missing[0]}; "
                         "this traffic needs Graph500's parent trees")


def obs():
    """The port's ``repro_torch.obs``."""
    from repro_torch import obs as port_obs
    return port_obs


def tree_counts() -> dict:
    """Totals of the port's ``tree_passes_total`` and
    ``tree_tie_rounds_total`` over every ``app`` label (0 before any)."""
    snap = obs().registry().snapshot()
    return {name: int(sum((snap.get(name) or {"series": {}})["series"]
                          .values()))
            for name in ("tree_passes_total", "tree_tie_rounds_total")}
