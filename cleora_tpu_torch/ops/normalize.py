"""Row normalisation.

Reference semantics: ``l2_normalize_inplace`` (src/embedding.rs:88-104)
uses ``max(norm, 1e-10)``; the Python layer's ``_normalize``
(pycleora/__init__.py:942-960) adds l1 / spectral / none modes.

``l2_normalize`` and ``l1_normalize`` work IN PLACE on a float32 tensor and
return it (the loop hands them the fresh SpMM output): on CUDA through
kernel K2 (``kernels/row_normalize.cu``), on the CPU through their plain
versions, which do the same in place.
"""

from __future__ import annotations

import torch

from .. import kernels

EPS = 1e-10


def l2_normalize_plain(x: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x.div_(torch.clamp_min(norms, EPS))


def l1_normalize_plain(x: torch.Tensor) -> torch.Tensor:
    norms = torch.sum(torch.abs(x), dim=-1, keepdim=True)
    return x.div_(torch.clamp_min(norms, EPS))


def normalize_plain(x: torch.Tensor, method: str) -> torch.Tensor:
    """The plain versions of the row normalisations that K1 and the fused
    attention pass apply in their epilogue: ``"l2"``, ``"l1"`` (in place)
    or ``"none"``."""
    if method == "l2":
        return l2_normalize_plain(x)
    if method == "l1":
        return l1_normalize_plain(x)
    if method == "none":
        return x
    raise ValueError(f"normalize_plain: unknown normalization {method}")


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return kernels.row_normalize_(x, "l2")
    return l2_normalize_plain(x)


def l1_normalize(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return kernels.row_normalize_(x, "l1")
    return l1_normalize_plain(x)


def spectral_normalize(x: torch.Tensor) -> torch.Tensor:
    """L2-normalize rows then rescale by singular values: u * s of the SVD."""
    u, s, _ = torch.linalg.svd(l2_normalize(x), full_matrices=False)
    return u * s


def normalize(x: torch.Tensor, method: str) -> torch.Tensor:
    if method == "l2":
        return l2_normalize(x)
    if method == "l1":
        return l1_normalize(x)
    if method == "spectral":
        return spectral_normalize(x)
    if method == "none":
        return x
    raise ValueError(
        f"Unknown normalization method: {method}. Use 'l2', 'l1', 'spectral', or 'none'."
    )
