"""partition_s: host seconds of the port's ``build_partition`` in set-up
(for PageRank, of the first ``apps.pagerank`` call, made with zero
iterations, which builds it)."""


def read(facts):
    return facts.get("partition_s")
