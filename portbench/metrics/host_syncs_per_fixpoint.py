"""host_syncs_per_fixpoint: the port's ``engine_host_syncs_total``
counter's growth over the window, per fixpoint completed in it."""


def read(facts):
    if "host_syncs" not in facts or not facts.get("fixpoints"):
        return None
    return facts["host_syncs"] / facts["fixpoints"]
