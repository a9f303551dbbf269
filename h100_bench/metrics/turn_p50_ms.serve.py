"""The median turn latency in the window (host clock)."""

from h100_bench import readers


def read(obs):
    return readers.latency_ms(obs, 50)
