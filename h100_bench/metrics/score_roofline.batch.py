"""Kernel 2 (csrc/scores_groupmax.cu): % of its function's least time over its device time in the
traced segment."""

from h100_bench import readers


def read(obs):
    return readers.roofline(obs, "scores", readers.SCORES)
