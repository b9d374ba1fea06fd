"""ctypes bindings of the port's hand-written CUDA kernels.

K1 ``spmm_csr.cu``, K2 ``row_normalize.cu``, K3 ``hash_init.cu``, K4
``edge_attention.cu``, K5 ``spmm_axpy.cu``, K6 ``dense_markov.cu`` and K7
``log_clip.cu`` are built at first use (:mod:`.build`).  Each wrapper
checks device, dtype, shape and contiguity, launches on PyTorch's current
stream, raises if the launch is refused, and adds one to its entry in
:data:`LAUNCHES`.  The wrappers take CUDA tensors
only; the plain PyTorch versions live beside their callers in ``ops/``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

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
    # indptr, indices, vals, x, z, acc, out, n_rows, d, a, b, c, dd, vec4, stream
    "spmm_axpy": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                  _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64,
                  _c.c_int64, _c.c_float, _c.c_float, _c.c_float, _c.c_float,
                  _c.c_int, _c.c_void_p],
    # indptr, indices, vals, p, deg, vol, n, vec4, stream
    "dense_markov": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                     _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_int,
                     _c.c_void_p],
    # x, r, c, n, m, floor, offset, vec4, stream
    "log_clip": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64,
                 _c.c_int64, _c.c_float, _c.c_float, _c.c_int, _c.c_void_p],
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


def _require_csr(name: str, indptr: torch.Tensor, indices: torch.Tensor,
                 vals: torch.Tensor) -> None:
    _require(indptr.dtype == torch.int64 and indices.dtype == torch.int32
             and vals.dtype == torch.float32,
             f"{name}: indptr int64, indices int32 and vals float32 expected")
    _require(indptr.dim() == 1 and indptr.shape[0] >= 1
             and indices.shape == vals.shape and indices.dim() == 1,
             f"{name}: indptr/indices/vals mismatch")


def _require_cuda_contiguous(name: str, device, *tensors) -> None:
    _require(all(t.is_contiguous() for t in tensors),
             f"{name}: operands must be contiguous")
    _require(all(t.is_cuda and t.device == device for t in tensors),
             f"{name}: every operand must be on the same CUDA device")


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _byte_range(t: torch.Tensor):
    """[first, last) address that a tensor with non-negative strides
    reaches."""
    reach = sum((n - 1) * s for n, s in zip(t.shape, t.stride())) + 1
    first = t.data_ptr()
    return first, first + (reach * t.element_size() if t.numel() else 0)


def _overlap(s: torch.Tensor, t: torch.Tensor) -> bool:
    """Whether the address ranges of two tensors meet (views of one
    storage that interleave without sharing an element count as meeting)."""
    (s0, s1), (t0, t1) = _byte_range(s), _byte_range(t)
    return s0 < t1 and t0 < s1


def spmm_axpy(indptr: torch.Tensor, indices: torch.Tensor, vals: torch.Tensor,
              x: torch.Tensor, a: float, b: float = 0.0,
              z: Optional[torch.Tensor] = None, c: float = 0.0,
              acc: Optional[torch.Tensor] = None,
              d: float = 0.0) -> torch.Tensor:
    """K5: ``out = a·(A @ x) + b·x + c·z`` (A in CSR) as a new float32
    (N, D) tensor, and ``acc += d·out`` in place when ``acc`` is given."""
    name = "spmm_axpy"
    n = indptr.shape[0] - 1
    _require_csr(name, indptr, indices, vals)
    dense = [t for t in (x, z, acc) if t is not None]
    for t in dense:
        _require(t.dtype == torch.float32 and t.dim() == 2,
                 f"{name}: x, z and acc must be 2-D float32 tensors")
        _require(t.shape == x.shape, f"{name}: x, z and acc shapes differ")
    _require(x.shape[0] == n, f"{name}: x must have one row per row of A")
    # the kernel reads x and z through the read-only cache, and other rows
    # gather x, while a row's thread updates acc
    _require(acc is None or not any(_overlap(acc, t) for t in (x, z)
                                    if t is not None),
             f"{name}: acc must not share memory with x or z")
    _require_cuda_contiguous(name, x.device, indptr, indices, vals, *dense)
    width = x.shape[1]
    out = torch.empty_like(x)
    vec4 = width % 4 == 0 and _aligned16(out, *dense)
    fn = _bound(name)
    with torch.cuda.device(x.device):
        rc = fn(indptr.data_ptr(), indices.data_ptr(), vals.data_ptr(),
                x.data_ptr(), None if z is None else z.data_ptr(),
                None if acc is None else acc.data_ptr(), out.data_ptr(),
                n, width, float(a), float(b), float(c), float(d), int(vec4),
                torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(name, rc)
    return out


def dense_markov(indptr: torch.Tensor, indices: torch.Tensor,
                 vals: torch.Tensor):
    """K6: the dense row-normalised matrix of a square CSR.  Returns
    ``(P, deg, vol)``: float32 (n, n) with duplicate entries summed and each
    row divided by ``deg = max(row sum, 1e-10)`` (float32 (n,)), and the
    sum of all entries as a float64 (1,) tensor."""
    name = "dense_markov"
    n = indptr.shape[0] - 1
    _require_csr(name, indptr, indices, vals)
    _require_cuda_contiguous(name, vals.device, indptr, indices, vals)
    p = torch.empty((n, n), dtype=torch.float32, device=vals.device)
    deg = torch.empty((n,), dtype=torch.float32, device=vals.device)
    vol = torch.zeros((1,), dtype=torch.float64, device=vals.device)
    vec4 = n % 4 == 0 and _aligned16(p)
    fn = _bound(name)
    with torch.cuda.device(vals.device):
        rc = fn(indptr.data_ptr(), indices.data_ptr(), vals.data_ptr(),
                p.data_ptr(), deg.data_ptr(), vol.data_ptr(), n, int(vec4),
                torch.cuda.current_stream(vals.device).cuda_stream)
    _check_launch(name, rc)
    return p, deg, vol


def log_clip_(x: torch.Tensor, row_scale: Optional[torch.Tensor],
              col_scale: Optional[torch.Tensor], floor: float,
              offset: float) -> torch.Tensor:
    """K7: ``x[i, j] = log(max(x[i, j]·row_scale[i]·col_scale[j], floor)) −
    offset`` in place on float32 (n, m) ``x``; a scale that is None is a
    factor of 1.  Returns ``x``."""
    name = "log_clip_"
    scales = [t for t in (row_scale, col_scale) if t is not None]
    for t in (x, *scales):
        _require(t.dtype == torch.float32, f"{name}: float32 tensors expected")
    _require(x.dim() == 2, f"{name}: x must be 2-D")
    n, m = x.shape
    _require(row_scale is None or row_scale.shape == (n,),
             f"{name}: row_scale must have one entry per row of x")
    _require(col_scale is None or col_scale.shape == (m,),
             f"{name}: col_scale must have one entry per column of x")
    _require_cuda_contiguous(name, x.device, x, *scales)
    vec4 = m % 4 == 0 and _aligned16(
        x, *([] if col_scale is None else [col_scale]))
    fn = _bound("log_clip")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), None if row_scale is None else row_scale.data_ptr(),
                None if col_scale is None else col_scale.data_ptr(), n, m,
                float(floor), float(offset), int(vec4),
                torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch("log_clip", rc)
    return x
