"""The 95th percentile of every turn's host-clock latency in the window."""

from h100_bench import readers


def read(obs):
    return readers.latency_ms(obs, 95)
