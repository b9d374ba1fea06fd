"""Device-memory footprint check for the embed loop.

Turns an out-of-memory failure deep inside the loop into an actionable
ValueError before any work is done (the JAX package's check, recomputed
for the CSR layout and measured against the card's free memory).
"""

from __future__ import annotations

import os

import torch


def estimate_embed_bytes(n_rows: int, d: int, nnz: int,
                         dtype: str = "float32") -> int:
    """Upper-bound device bytes for one embed loop at this shape.

    Components: the state and the state of the step before it (storage
    dtype), the f32 SpMM output, the whitening temporaries (centred copy and
    projection, f32), and the CSR (int32 indices + f32 vals per edge, int64
    indptr per row).
    """
    state_itemsize = 2 if dtype == "bfloat16" else 4
    state = 2 * n_rows * d * state_itemsize
    out = n_rows * d * 4
    whiten_tmp = 2 * n_rows * d * 4
    csr = nnz * 8 + (n_rows + 1) * 8
    return state + out + whiten_tmp + csr


def device_memory_limit(device: torch.device) -> int | None:
    """Bytes the loop can still get on ``device``: the card's free memory
    plus what PyTorch's allocator holds unused.  None on the CPU."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int(free + cached)


def check_device_fit(n_rows: int, d: int, nnz: int, dtype: str = "float32",
                     device: torch.device = torch.device("cuda")) -> None:
    """Raise ValueError before dispatch when the loop cannot fit."""
    if os.environ.get("CLEORA_TPU_SKIP_FIT_CHECK") == "1":
        return
    limit = device_memory_limit(device)
    if limit is None:
        return
    need = estimate_embed_bytes(n_rows, d, nnz, dtype)
    if need > limit:
        gib = 1 << 30
        hints = []
        if dtype != "bfloat16":
            bf16 = estimate_embed_bytes(n_rows, d, nnz, "bfloat16")
            if bf16 <= limit:
                hints.append('pass dtype="bfloat16" (halves the state)')
        hints.append("reduce feature_dim")
        raise ValueError(
            f"Embedding loop needs ~{need / gib:.1f} GiB of device memory for "
            f"{n_rows} rows x dim {d} ({nnz} edges, {dtype}) but the device "
            f"has {limit / gib:.1f} GiB free. Options: {'; '.join(hints)}. "
            f"Set CLEORA_TPU_SKIP_FIT_CHECK=1 to bypass this estimate."
        )
