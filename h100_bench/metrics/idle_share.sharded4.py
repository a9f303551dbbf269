"""% of rank 0's traced calls in which its device ran nothing."""

from h100_bench import readers


def read(obs):
    return readers.idle_share(obs)
