"""ctypes bindings of the port's hand-written CUDA kernels.

K1 ``spmm_csr.cu`` and K2 ``row_normalize.cu`` are built at first use
(:mod:`.build`).  Each wrapper checks device, dtype, shape and contiguity,
launches on PyTorch's current stream, raises if the launch is refused, and
adds one to its entry in :data:`LAUNCHES`.  The wrappers take CUDA tensors
only; the plain PyTorch versions live beside their callers in ``ops/``.
"""

from __future__ import annotations

import ctypes

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
