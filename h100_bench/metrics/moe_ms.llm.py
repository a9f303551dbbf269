"""Device ms a pass inside the expert layers (the span convdr.moe.experts: the router, the
ordering, the grouped SwiGLU kernels, the combine and the shared experts) in the traced passes."""

from h100_bench.spans import program_span


def read(obs):
    s = program_span(obs, "convdr.moe.experts", "device_s", "convdr.embed.pass")
    return None if s is None else 1e3 * s
