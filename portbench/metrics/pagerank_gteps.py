"""pagerank_gteps: PageRank runs completed in the window x edges x
iterations, over the window's seconds, in billions."""


def read(facts):
    if not facts.get("pagerank_runs"):
        return None
    return facts["pagerank_edge_iters"] / facts["window_s"] / 1e9
