"""occupancy: live lanes per tick over the lanes, in the window's ticks
(``QueryServer.occupancy_trace``), as a percentage."""


def read(facts):
    if facts.get("occupancy") is None:
        return None
    return 100.0 * facts["occupancy"]
