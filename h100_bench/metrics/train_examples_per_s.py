"""Examples of the optimizer steps completed in the window, over the window."""

from h100_bench import readers


def read(obs):
    return readers.rate(obs)
