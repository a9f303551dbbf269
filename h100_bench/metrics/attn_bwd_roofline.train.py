"""Kernel 1b f32 (csrc/flash_attention_bwd.cu, its D pre-pass included): % of its function's least
time over its device time in the traced steps."""

from h100_bench import readers


def read(obs):
    return readers.roofline(obs, "attn_bwd", readers.ATTN_BWD)
