"""The most-loaded routed expert's rows over the mean, averaged over the expert layers and the
batches of the traced passes (the port's device counters, moe_stats)."""


def read(obs):
    return (obs.get("moe") or {}).get("load_max_mean")
