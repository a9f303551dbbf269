"""Device ms of the search alone: a graph of the search closure (flat_ip_topk) replayed on the
window's query embeddings."""

from h100_bench import readers


def read(obs):
    return readers.span_ms(obs, "search")
