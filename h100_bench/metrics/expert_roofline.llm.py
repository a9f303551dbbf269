"""The grouped expert kernels (ops/moe.py, Triton): % of the expert layers' SwiGLU least time
(the passages' routed rows at the bf16 peak, or the experts' weights and rows at the memory
bandwidth) over the kernels' device time in the traced passes."""

from h100_bench import readers


def read(obs):
    return readers.roofline(obs, "experts", ("_swiglu_",))
