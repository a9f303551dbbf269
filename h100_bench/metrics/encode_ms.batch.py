"""Device ms of the query encode alone: a graph of OnlineSearcher.encode replayed on the window's
queries."""

from h100_bench import readers


def read(obs):
    return readers.span_ms(obs, "encode")
