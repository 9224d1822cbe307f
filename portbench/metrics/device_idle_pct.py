"""device_idle_pct: the share of the traced window in which no kernel or
copy ran on the card, as a percentage."""


def read(facts):
    tr = facts.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
