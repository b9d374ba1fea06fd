"""Small shared helpers: host copies and the device rule."""

from __future__ import annotations

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
