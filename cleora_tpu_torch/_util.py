"""Small shared helpers: host copies, the device rule and the float32
matmul guard."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch


def to_host(t: torch.Tensor) -> np.ndarray:
    """Tensor → WRITABLE float32 host ndarray (bf16 is cast to float32
    first: numpy has no bfloat16).  The public API returns plain numpy that
    users mutate in place (the reference README's
    ``embeddings /= np.linalg.norm(...)``), so the array never shares
    memory with ``t``."""
    return t.detach().to(device="cpu", dtype=torch.float32, copy=True).numpy()


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means CUDA.  A CUDA device without a card raises: the port
    never carries on quietly on the CPU, which runs only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device '{dev}'. Use 'cuda' or 'cpu'.")
    if dev.type == "cuda" and dev.index is None:
        # one spelling per card, so per-device caches hold one copy
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def full_float32_matmul():
    """Float32 matrix products in full float32 inside the block, whatever
    the caller set: the float32 matmul precision goes to "highest" (so
    ``torch.backends.cuda.matmul.allow_tf32`` reads False) and the caller's
    setting is put back on exit, "medium" as "medium" and not as the
    "high" that a restored ``allow_tf32 = True`` would leave.  The JAX
    package pins ``Precision.HIGHEST`` on the same products, which are
    compared with float64 host paths.  Usable as a decorator.  The setting
    is the process's, so two threads must not be inside at once."""
    matmul = torch.backends.cuda.matmul
    try:
        previous = torch.get_float32_matmul_precision()
        restore = torch.set_float32_matmul_precision
        restore("highest")
    except RuntimeError:
        # the caller chose through matmul.fp32_precision, which makes torch
        # refuse to read the older, process-wide setting
        previous = matmul.fp32_precision

        def restore(value):
            matmul.fp32_precision = value

        restore("ieee")
    try:
        yield
    finally:
        restore(previous)
