"""tree_roofline_pct: the least time of the window's parent passes at the
card's memory rate (``benchlib.graph500.tree_bytes``, counted from the
graph and the reference's searches) over the summed device time of K10's
kernels (``tree_parents`` in their names) in the window's trace, as a
percentage."""
from benchlib.bounds import bound_seconds


def read(facts):
    if not facts.get("tree_device_s") or not facts.get("tree_bytes"):
        return None
    return 100.0 * bound_seconds(facts["tree_bytes"]) / facts["tree_device_s"]
