"""device_roofline_pct: the least time the window's work needs at the
card's memory rate (``benchlib.bounds``: counted from the graph and the
reference's searches) over the summed device time of every kernel and
copy in the window's trace, as a percentage."""
from benchlib.bounds import bound_seconds


def read(facts):
    tr = facts.get("trace")
    if not tr or not tr["device_s"] or not facts.get("bound_bytes"):
        return None
    return 100.0 * bound_seconds(facts["bound_bytes"]) / tr["device_s"]
