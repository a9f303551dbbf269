"""Kernel 1 bf16 (csrc/flash_attention.cu): % of its function's least time over its device
time in the traced passes."""

from h100_bench import readers


def read(obs):
    return readers.roofline(obs, "attn_fwd", readers.ATTN_FWD)
