"""tree_ms_per_call: host milliseconds of the port's ``app.tree`` spans
(the parent pass after a search's fixpoint, and its read) in the traced
window, over the ``app.call`` spans started in it.  Nothing to read where
the run traced no ``app.tree`` span."""


def read(facts):
    if "tree_span_s" not in facts or not facts.get("tree_calls"):
        return None
    return 1e3 * facts["tree_span_s"] / facts["tree_calls"]
