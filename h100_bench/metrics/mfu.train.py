"""% of the window the steps' least times fill: student forward and backward (3x) and the teacher's
forwards, on valid tokens, at the bf16 peak."""

from h100_bench import readers


def read(obs):
    return readers.mfu(obs)
