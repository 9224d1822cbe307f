"""ms_per_tick: the window's milliseconds over the server ticks
(``QueryServer.tick``) made in it."""


def read(facts):
    if not facts.get("ticks"):
        return None
    return 1e3 * facts["window_s"] / facts["ticks"]
