"""queries_per_s: queries answered ``ok`` in the window over its
seconds."""


def read(facts):
    if "queries_ok" not in facts:
        return None
    return facts["queries_ok"] / facts["window_s"]
