"""% of the traced passes in which the device ran nothing."""

from h100_bench import readers


def read(obs):
    return readers.idle_share(obs)
