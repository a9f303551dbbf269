"""Kernel 1's causal (192, 128) variant (csrc/flash_attention.cu): % of the latent attention's
least time over the passages' valid causal pairs over its device time in the traced passes."""

from h100_bench import readers


def read(obs):
    return readers.roofline(obs, "mla", ("flash_fwd_causal",))
