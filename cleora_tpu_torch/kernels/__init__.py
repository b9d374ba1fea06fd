"""ctypes bindings of the port's hand-written CUDA kernels.

K1 ``spmm_csr.cu``, K2 ``row_normalize.cu``, K3 ``hash_init.cu`` and K4
``edge_attention.cu`` are built at first use (:mod:`.build`).  Each wrapper
checks device, dtype, shape and contiguity, launches on PyTorch's current
stream, raises if the launch is refused, and adds one to its entry in
:data:`LAUNCHES`.  The wrappers take CUDA tensors
only; the plain PyTorch versions live beside their callers in ``ops/``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

LAUNCHES = {name: 0 for name in build.KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_c = ctypes
_ARGTYPES = {
    # indptr, indices, vals, x, x_bf16, out, n_rows, d, keep, w, vec4, stream
    "spmm_csr": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int,
                 _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_float, _c.c_float,
                 _c.c_int, _c.c_void_p],
    # x, n_rows, d, mode, vec4, stream
    "row_normalize": [_c.c_void_p, _c.c_int64, _c.c_int64, _c.c_int, _c.c_int,
                      _c.c_void_p],
    # hashes, out, n_rows, d, seed, vec4, stream
    "hash_init": [_c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_int64,
                  _c.c_int, _c.c_void_p],
    # indptr, indices, vals, xn, out, n_rows, d, temperature, vec4, stream
    "edge_attention": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                       _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_float,
                       _c.c_int, _c.c_void_p],
}


def _bound(name: str):
    fn = getattr(build.load(name), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def spmm_csr(indptr: torch.Tensor, indices: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, residual_weight: float = 0.0) -> torch.Tensor:
    """K1: ``out = A @ x`` (A in CSR), then ``(1-w)·out + w·x`` for w > 0.
    Returns a new float32 (N, D) tensor."""
    n = indptr.shape[0] - 1
    for t in (indptr, indices, vals, x):
        _require(t.is_cuda and t.device == x.device,
                 "spmm_csr: every operand must be on the same CUDA device")
        _require(t.is_contiguous(), "spmm_csr: operands must be contiguous")
    _require(indptr.dtype == torch.int64 and indices.dtype == torch.int32
             and vals.dtype == torch.float32,
             "spmm_csr: indptr int64, indices int32 and vals float32 expected")
    _require(x.dtype in (torch.float32, torch.bfloat16) and x.dim() == 2,
             "spmm_csr: x must be a 2-D float32 or bfloat16 tensor")
    _require(indices.shape == vals.shape, "spmm_csr: indices/vals mismatch")
    _require(x.shape[0] >= n, "spmm_csr: x has fewer rows than A")
    d = x.shape[1]
    w = float(residual_weight)
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    vec4 = d % 4 == 0 and x.data_ptr() % (8 if bf16 else 16) == 0
    fn = _bound("spmm_csr")
    with torch.cuda.device(x.device):
        rc = fn(indptr.data_ptr(), indices.data_ptr(), vals.data_ptr(),
                x.data_ptr(), int(bf16), out.data_ptr(), n, d,
                1.0 - w, w, int(vec4),
                torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch("spmm_csr", rc)
    return out


_MODES = {"l2": 0, "l1": 1}


def row_normalize_(x: torch.Tensor, method: str) -> torch.Tensor:
    """K2: divide each row of float32 ``x`` by max(its l2 or l1 norm,
    1e-10), in place.  Returns ``x``."""
    _require(method in _MODES, f"row_normalize_: unknown method {method}")
    _require(x.is_cuda and x.dtype == torch.float32 and x.dim() == 2
             and x.is_contiguous(),
             "row_normalize_: x must be a contiguous 2-D float32 CUDA tensor")
    n, d = x.shape
    vec4 = d % 4 == 0 and x.data_ptr() % 16 == 0
    fn = _bound("row_normalize")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), n, d, _MODES[method], int(vec4),
                torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch("row_normalize", rc)
    return x


def hash_init(hashes: torch.Tensor, feature_dim: int,
              seed: int = 0) -> torch.Tensor:
    """K3: the deterministic hash init, ``(N, feature_dim)`` float32, from
    the entity hashes carried as an int64 view of their uint64 bits.  The
    seed must fit int64, as the host init requires."""
    _require(hashes.is_cuda and hashes.dtype == torch.int64
             and hashes.dim() == 1 and hashes.is_contiguous(),
             "hash_init: hashes must be a contiguous 1-D int64 CUDA tensor")
    d = int(feature_dim)
    _require(d >= 0, "hash_init: feature_dim must be non-negative")
    n = hashes.shape[0]
    out = torch.empty((n, d), dtype=torch.float32, device=hashes.device)
    vec4 = d % 4 == 0 and out.data_ptr() % 16 == 0
    fn = _bound("hash_init")
    with torch.cuda.device(hashes.device):
        rc = fn(hashes.data_ptr(), out.data_ptr(), n, d, int(np.int64(seed)),
                int(vec4), torch.cuda.current_stream(hashes.device).cuda_stream)
    _check_launch("hash_init", rc)
    return out


def edge_attention(indptr: torch.Tensor, indices: torch.Tensor,
                   vals: torch.Tensor, xn: torch.Tensor,
                   temperature: float) -> torch.Tensor:
    """K4: the attention-reweighted, row-renormalised edge values of the
    CSR matrix for the row-normalised state ``xn``.  Returns a new float32
    (nnz,) tensor."""
    n = indptr.shape[0] - 1
    for t in (indptr, indices, vals, xn):
        _require(t.is_cuda and t.device == xn.device,
                 "edge_attention: every operand must be on the same CUDA device")
        _require(t.is_contiguous(), "edge_attention: operands must be contiguous")
    _require(indptr.dtype == torch.int64 and indices.dtype == torch.int32
             and vals.dtype == torch.float32,
             "edge_attention: indptr int64, indices int32 and vals float32 expected")
    _require(xn.dtype == torch.float32 and xn.dim() == 2,
             "edge_attention: xn must be a 2-D float32 tensor")
    _require(indices.shape == vals.shape, "edge_attention: indices/vals mismatch")
    _require(xn.shape[0] >= n, "edge_attention: xn has fewer rows than A")
    d = xn.shape[1]
    out = torch.empty_like(vals)
    vec4 = d % 4 == 0 and xn.data_ptr() % 16 == 0
    fn = _bound("edge_attention")
    with torch.cuda.device(xn.device):
        rc = fn(indptr.data_ptr(), indices.data_ptr(), vals.data_ptr(),
                xn.data_ptr(), out.data_ptr(), n, d, float(temperature),
                int(vec4), torch.cuda.current_stream(xn.device).cuda_stream)
    _check_launch("edge_attention", rc)
    return out
