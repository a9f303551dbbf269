"""Passages whose embeddings were written in the window, over the window."""

from h100_bench import readers


def read(obs):
    return readers.rate(obs)
