"""setup_s: host seconds from the process's start to the first timed
call: graph generation, the partition, uploads, kernel builds and every
warm-up call."""


def read(facts):
    return facts.get("setup_s")
