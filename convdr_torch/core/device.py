"""Device selection and float32 matmul settings for every entry point.

The port runs on the card unless the caller asks for the CPU (``--no_cuda``
in the drivers, ``no_cuda=True`` in code; the CPU tests do so). Without the
request and without a card it raises: nothing carries on on the CPU.
"""

from __future__ import annotations

import torch


def set_exact_matmul() -> None:
    """Full-f32 products everywhere: TF32 keeps about three decimal digits,
    which reorders close candidates and breaks the exact-search contract
    (ops/exact_search.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(no_cuda: bool = False) -> torch.device:
    set_exact_matmul()
    if no_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --no_cuda (no_cuda=True) to "
            "run on the CPU"
        )
    return torch.device("cuda")


def pick_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card (raising without
    one), as :func:`resolve_device`. Either way TF32 is off."""
    if device is None:
        return resolve_device()
    set_exact_matmul()
    return torch.device(device)
