"""% of the window the passes' least times fill: the decoder's active operations on the
passages' valid tokens (k routed and the shared experts a token, causal pairs) at the bf16
peak."""

from h100_bench import readers


def read(obs):
    return readers.mfu(obs)
