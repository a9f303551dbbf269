"""PyTorch/CUDA port of convdr_tpu: conversational dense retrieval on one
NVIDIA H100.

A second package beside the JAX reference (``convdr_tpu``). It imports
``torch`` and numpy and never JAX or anything of ``convdr_tpu``; its
hand-written kernels live in ``csrc/`` and build with ``nvcc`` at first use.
"""
