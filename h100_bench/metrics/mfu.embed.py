"""% of the window the passes' least times fill: encoder operations on valid tokens at the bf16
peak."""

from h100_bench import readers


def read(obs):
    return readers.mfu(obs)
