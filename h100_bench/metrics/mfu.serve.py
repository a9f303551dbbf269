"""% of the window the calls' least times fill: encoder operations on valid tokens at the bf16 peak
plus the search's bound."""

from h100_bench import readers


def read(obs):
    return readers.mfu(obs)
