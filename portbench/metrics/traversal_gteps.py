"""traversal_gteps: Graph500's TEPS count (the input edges out of every
vertex a search reached, from the reference) summed over the BFS and
SSSP fixpoints completed in the window, over the window's seconds, in
billions."""


def read(facts):
    if not facts.get("fixpoints"):
        return None
    return facts["teps_edges"] / facts["window_s"] / 1e9
