"""Queries whose top-k came back in the window, over the window."""

from h100_bench import readers


def read(obs):
    return readers.rate(obs)
