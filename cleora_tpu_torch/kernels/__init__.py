"""ctypes bindings of the port's hand-written CUDA kernels.

K1 ``spmm_csr.cu``, K2 ``row_normalize.cu``, K3 ``hash_init.cu``, K4
``edge_attention.cu``, K5 ``spmm_axpy.cu``, K6 ``dense_markov.cu``, K7
``log_clip.cu``, K8 ``walk_uniform.cu``, K9 ``pair_enum.cu``, K10
``run_length.cu``, K11 ``ppmi.cu``, K12 ``walk_p_q.cu``, K13
``pq_adc.cu``, K14 ``label_prop.cu``, K15 ``relu_dropout.cu`` and K16
``halo_pack.cu`` are built at first use (:mod:`.build`).  Each wrapper
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
    # indptr, indices, vals, x, x_bf16, res, out, n_rows, d, keep, w, vec4,
    # stream
    "spmm_csr": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int,
                 _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_float,
                 _c.c_float, _c.c_int, _c.c_void_p],
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
    # indptr, cols, deg, starts, walks, batch, walk_length, base, k0, k1, n,
    # stream
    "walk_uniform": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                     _c.c_void_p, _c.c_int64, _c.c_int, _c.c_int64,
                     _c.c_uint32, _c.c_uint32, _c.c_int32, _c.c_void_p],
    # indptr, cols, vals, deg, wmax, wsum, starts, walks, batch, walk_length,
    # base, k0, k1, n, inv_p, inv_q, tries, stream
    "walk_p_q": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                 _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                 _c.c_int64, _c.c_int, _c.c_int64, _c.c_uint32, _c.c_uint32,
                 _c.c_int32, _c.c_float, _c.c_float, _c.c_int, _c.c_void_p],
    # tables, codes, code_bytes, scores, q, n, m, c, stream
    "pq_adc": [_c.c_void_p, _c.c_void_p, _c.c_int, _c.c_void_p, _c.c_int64,
               _c.c_int64, _c.c_int, _c.c_int, _c.c_void_p],
    # walks, batch, walk_length, n_valid, n, passes, window, keys, stream
    "pair_enum": [_c.c_void_p, _c.c_int64, _c.c_int, _c.c_int64, _c.c_int64,
                  _c.c_int64, _c.c_int, _c.c_void_p, _c.c_void_p],
    # keys, len, heads, stream
    "run_length_heads": [_c.c_void_p, _c.c_int64, _c.c_void_p, _c.c_void_p],
    # keys, counts, heads, pos, len, n, passes, cen, ctx, cnt, m_per, stream
    "run_length": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                   _c.c_int64, _c.c_int64, _c.c_int, _c.c_void_p,
                   _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p],
    # ctx, cnt, m, col, total, stream
    "ppmi_colsum": [_c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_void_p,
                    _c.c_void_p, _c.c_void_p],
    # cen, ctx, cnt, m, n, col, total, vals, indptr, stream
    "ppmi": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_int64,
             _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
             _c.c_void_p],
    # indptr, indices, vals, f, y, mask, out, n_rows, c, alpha, beta, stream
    "label_prop": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                   _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64,
                   _c.c_int64, _c.c_float, _c.c_float, _c.c_void_p],
    # z, h, numel, p, q, k0, k1, epoch, layer, stream
    "relu_dropout": [_c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_float,
                     _c.c_float, _c.c_uint32, _c.c_uint32, _c.c_uint32,
                     _c.c_uint32, _c.c_void_p],
    # z, dh, dz, numel, p, q, k0, k1, epoch, layer, stream
    "relu_dropout_backward": [_c.c_void_p, _c.c_void_p, _c.c_void_p,
                              _c.c_int64, _c.c_float, _c.c_float, _c.c_uint32,
                              _c.c_uint32, _c.c_uint32, _c.c_uint32,
                              _c.c_void_p],
    # idx, x, out, n_slots, row_bytes, vec_bytes, stream
    "halo_pack": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64,
                  _c.c_int64, _c.c_int, _c.c_void_p],
}


def _bound(name: str, entry: Optional[str] = None):
    """The launch function ``<entry>_launch`` of kernel library ``name``
    (``entry`` defaults to ``name``; K10 and K11 export two)."""
    entry = entry or name
    fn = getattr(build.load(name), f"{entry}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[entry]
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _check_launch(name: str, rc: int) -> None:
    _check_rc(name, rc)
    LAUNCHES[name] += 1


def spmm_csr(indptr: torch.Tensor, indices: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, residual_weight: float = 0.0,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: ``out = A @ x`` (A in CSR), then ``(1-w)·out + w·r`` for w > 0,
    where ``r`` is ``residual`` (default ``x``): the sharded loop gathers
    from a table that is not the shard's own state.  Returns a new float32
    (N, D) tensor."""
    n = indptr.shape[0] - 1
    res = x if residual is None else residual
    for t in (indptr, indices, vals, x, res):
        _require(t.is_cuda and t.device == x.device,
                 "spmm_csr: every operand must be on the same CUDA device")
        _require(t.is_contiguous(), "spmm_csr: operands must be contiguous")
    _require(indptr.dtype == torch.int64 and indices.dtype == torch.int32
             and vals.dtype == torch.float32,
             "spmm_csr: indptr int64, indices int32 and vals float32 expected")
    _require(x.dtype in (torch.float32, torch.bfloat16) and x.dim() == 2,
             "spmm_csr: x must be a 2-D float32 or bfloat16 tensor")
    _require(res.dtype == x.dtype and res.dim() == 2
             and res.shape[1] == x.shape[1],
             "spmm_csr: residual must match x's dtype and width")
    _require(indices.shape == vals.shape, "spmm_csr: indices/vals mismatch")
    _require(res.shape[0] >= n, "spmm_csr: x has fewer rows than A"
             if residual is None else
             "spmm_csr: residual has fewer rows than A")
    d = x.shape[1]
    w = float(residual_weight)
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    align = 8 if bf16 else 16
    vec4 = (d % 4 == 0 and x.data_ptr() % align == 0
            and res.data_ptr() % align == 0)
    fn = _bound("spmm_csr")
    with torch.cuda.device(x.device):
        rc = fn(indptr.data_ptr(), indices.data_ptr(), vals.data_ptr(),
                x.data_ptr(), int(bf16), res.data_ptr(), out.data_ptr(), n, d,
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


_U32 = 0xFFFFFFFF


def walk_uniform(indptr: torch.Tensor, cols: torch.Tensor, deg: torch.Tensor,
                 starts: torch.Tensor, walk_length: int, seed: int,
                 base: int, n: int) -> torch.Tensor:
    """K8: one first-order uniform walk of ``walk_length`` nodes from each
    of ``starts`` (int32 (B,); the sentinel ``n`` marks a pad lane) over the
    walk CSR (``indptr`` row starts, ``cols``, ``deg``: int32).  Lane ``b``
    is the walk of global index ``base + b`` and draws from Philox4x32-10
    keyed by ``seed``.  Returns a new int32 (B, walk_length) tensor.  The
    tables must be valid (``ops/walk.py:WalkTables`` checks them once)."""
    name = "walk_uniform"
    for t in (indptr, cols, deg, starts):
        _require(t.dtype == torch.int32 and t.dim() == 1,
                 f"{name}: int32 1-D tables and starts expected")
    _require(indptr.shape == deg.shape and indptr.shape[0] == n,
             f"{name}: indptr and deg must have one entry per node")
    _require(walk_length >= 1 and base >= 0,
             f"{name}: walk_length >= 1 and base >= 0 expected")
    _require_cuda_contiguous(name, starts.device, indptr, cols, deg, starts)
    batch = starts.shape[0]
    walks = torch.empty((batch, walk_length), dtype=torch.int32,
                        device=starts.device)
    key = int(seed) & ((1 << 64) - 1)
    fn = _bound(name)
    with torch.cuda.device(starts.device):
        rc = fn(indptr.data_ptr(), cols.data_ptr(), deg.data_ptr(),
                starts.data_ptr(), walks.data_ptr(), batch, int(walk_length),
                int(base), key & _U32, key >> 32, int(n),
                torch.cuda.current_stream(starts.device).cuda_stream)
    _check_launch(name, rc)
    return walks


def walk_p_q(indptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             deg: torch.Tensor, wmax: torch.Tensor, wsum: torch.Tensor,
             starts: torch.Tensor, walk_length: int, inv_p: float,
             inv_q: float, tries: int, seed: int, base: int,
             n: int) -> torch.Tensor:
    """K12: one second-order (Node2Vec p/q) walk of ``walk_length`` nodes
    from each of ``starts`` (int32 (B,); the sentinel ``n`` marks a pad
    lane) over the weighted walk CSR (``indptr``, ``cols``, ``deg``: int32;
    ``vals`` float32 per column; ``wmax``, ``wsum`` float32 per node), with
    ``inv_p``/``inv_q`` rounded to float32 and at most ``tries`` proposals
    per hop.  Lane ``b`` is the walk of global index ``base + b`` and draws
    from Philox4x32-10 keyed by ``seed``.  Returns a new int32
    (B, walk_length) tensor.  The tables must be valid
    (``ops/walk.py:WalkTables2`` checks them once)."""
    name = "walk_p_q"
    for t in (indptr, cols, deg, starts):
        _require(t.dtype == torch.int32 and t.dim() == 1,
                 f"{name}: int32 1-D tables and starts expected")
    for t in (vals, wmax, wsum):
        _require(t.dtype == torch.float32 and t.dim() == 1,
                 f"{name}: float32 1-D vals, wmax and wsum expected")
    _require(indptr.shape == deg.shape == wmax.shape == wsum.shape
             and indptr.shape[0] == n,
             f"{name}: indptr, deg, wmax and wsum must have one entry per "
             "node")
    _require(vals.shape == cols.shape, f"{name}: vals must match cols")
    _require(walk_length >= 1 and base >= 0 and tries >= 1,
             f"{name}: walk_length >= 1, base >= 0 and tries >= 1 expected")
    _require_cuda_contiguous(name, starts.device, indptr, cols, vals, deg,
                             wmax, wsum, starts)
    batch = starts.shape[0]
    walks = torch.empty((batch, walk_length), dtype=torch.int32,
                        device=starts.device)
    key = int(seed) & ((1 << 64) - 1)
    fn = _bound(name)
    with torch.cuda.device(starts.device):
        rc = fn(indptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                deg.data_ptr(), wmax.data_ptr(), wsum.data_ptr(),
                starts.data_ptr(), walks.data_ptr(), batch, int(walk_length),
                int(base), key & _U32, key >> 32, int(n),
                float(np.float32(inv_p)), float(np.float32(inv_q)),
                int(tries),
                torch.cuda.current_stream(starts.device).cuda_stream)
    _check_launch(name, rc)
    return walks


_CODE_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}


def pq_adc(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """K13: the asymmetric-distance scores ``scores[q, i] = Σ_m
    tables[q, m, codes[i, m]]``, summed in ``m`` order in float32, from
    float32 (Q, M, C) ``tables`` and (N, M) ``codes`` (uint8, uint16 or
    int32).  Every code must lie in [0, C): the codes are uploaded once and
    checked there (``ops/pq.py:device_codes``), not on every search.
    Returns a new float32 (Q, N) tensor."""
    name = "pq_adc"
    _require(tables.dtype == torch.float32 and tables.dim() == 3,
             f"{name}: tables must be a 3-D float32 tensor")
    _require(codes.dtype in _CODE_BYTES and codes.dim() == 2,
             f"{name}: codes must be a 2-D uint8, uint16 or int32 tensor")
    q, m, c = tables.shape
    _require(codes.shape[1] == m and m >= 1 and c >= 1,
             f"{name}: codes need one column per subspace of tables")
    _require_cuda_contiguous(name, tables.device, tables, codes)
    n = codes.shape[0]
    scores = torch.empty((q, n), dtype=torch.float32, device=tables.device)
    if q == 0 or n == 0:
        return scores
    fn = _bound(name)
    with torch.cuda.device(tables.device):
        rc = fn(tables.data_ptr(), codes.data_ptr(), _CODE_BYTES[codes.dtype],
                scores.data_ptr(), q, n, m, c,
                torch.cuda.current_stream(tables.device).cuda_stream)
    _check_launch(name, rc)
    return scores


def pair_keys_fit(n: int, passes: int) -> None:
    """K9's packed key ``((cen % passes)·n + cen)·n + ctx`` is exact while
    ``passes·n² < 2⁶³``; raise ValueError past it."""
    if passes * n * n >= 1 << 63:
        raise ValueError(
            f"co-occurrence keys need passes * n^2 < 2^63 (passes={passes}, "
            f"n={n}); a walk CSR of that many nodes cannot fit one card")


def pair_enum(walks: torch.Tensor, n_valid: int, n: int, window: int,
              passes: int) -> torch.Tensor:
    """K9: the packed int64 sort keys of every windowed (center, context)
    pair of the first ``n_valid`` rows of int32 (B, L) ``walks``, both
    directions, in the JAX program's order; masked lanes hold INT64_MAX."""
    name = "pair_enum"
    _require(walks.dtype == torch.int32 and walks.dim() == 2,
             f"{name}: walks must be a 2-D int32 tensor")
    _require(passes >= 1 and window >= 1, f"{name}: passes, window >= 1")
    pair_keys_fit(n, passes)
    _require_cuda_contiguous(name, walks.device, walks)
    batch, length = walks.shape
    w = min(window, length - 1)
    lanes = 2 * batch * sum(length - o for o in range(1, w + 1))
    keys = torch.empty((lanes,), dtype=torch.int64, device=walks.device)
    if lanes == 0:
        return keys
    fn = _bound(name)
    with torch.cuda.device(walks.device):
        rc = fn(walks.data_ptr(), batch, length, int(n_valid), int(n),
                int(passes), w, keys.data_ptr(),
                torch.cuda.current_stream(walks.device).cuda_stream)
    _check_launch(name, rc)
    return keys


_MAX_PASSES = 8192  # run_reduce's per-block partition counts: 32 KB shared


def run_length(keys: torch.Tensor, counts: Optional[torch.Tensor], n: int,
               passes: int):
    """K10: the runs of ascending int64 ``keys`` (INT64_MAX = dead, at the
    end) as exactly sized int32 ``(cen, ctx, cnt)`` in key order, with
    ``cnt`` the run's sum of ``counts`` (int32, or 1 each when None) modulo
    2³², and int32 ``m_per`` (passes,), the runs of each partition.  A call
    launches the head-marking kernel, ``torch.cumsum`` and the reduce
    kernel."""
    name = "run_length"
    _require(keys.dtype == torch.int64 and keys.dim() == 1,
             f"{name}: keys must be a 1-D int64 tensor")
    _require(counts is None or (counts.dtype == torch.int32
                                and counts.shape == keys.shape),
             f"{name}: counts must be int32 with one entry per key")
    _require(1 <= passes <= _MAX_PASSES,
             f"{name}: passes must be in [1, {_MAX_PASSES}]")
    _require(keys.shape[0] < 1 << 31, f"{name}: at most 2^31 - 1 keys")
    dense = [keys] + ([] if counts is None else [counts])
    _require_cuda_contiguous(name, keys.device, *dense)
    dev = keys.device
    length = keys.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    heads = torch.empty((length,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _bound(name, "run_length_heads")(keys.data_ptr(), length,
                                              heads.data_ptr(), stream)
    _check_rc(name, rc)
    pos = torch.cumsum(heads, 0, dtype=torch.int32)
    m = int(pos[-1]) if length else 0
    cen, ctx, cnt = (torch.empty((m,), dtype=torch.int32, device=dev)
                     for _ in range(3))
    m_per = torch.zeros((passes,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _bound(name)(keys.data_ptr(),
                          None if counts is None else counts.data_ptr(),
                          heads.data_ptr(), pos.data_ptr(), length, int(n),
                          int(passes), cen.data_ptr(), ctx.data_ptr(),
                          cnt.data_ptr(), m_per.data_ptr(), stream)
    _check_launch(name, rc)
    return cen, ctx, cnt, m_per


def ppmi_colsum_(ctx: torch.Tensor, cnt: torch.Tensor, col: torch.Tensor,
                 total: torch.Tensor) -> None:
    """K11, first pass: ``col[ctx] += cnt`` and ``total += Σcnt`` in place,
    as int64 sums (``col`` int64 (n,), ``total`` int64 (1,))."""
    name = "ppmi"
    _require(ctx.dtype == torch.int32 and cnt.dtype == torch.int32
             and ctx.shape == cnt.shape and ctx.dim() == 1,
             f"{name}: ctx and cnt must be int32 of one shape")
    _require(col.dtype == torch.int64 and total.dtype == torch.int64
             and total.shape == (1,) and col.dim() == 1,
             f"{name}: col (n,) and total (1,) must be int64")
    _require_cuda_contiguous(name, ctx.device, ctx, cnt, col, total)
    with torch.cuda.device(ctx.device):
        rc = _bound(name, "ppmi_colsum")(
            ctx.data_ptr(), cnt.data_ptr(), ctx.shape[0], col.data_ptr(),
            total.data_ptr(), torch.cuda.current_stream(ctx.device).cuda_stream)
    _check_rc(name, rc)


def ppmi(cen: torch.Tensor, ctx: torch.Tensor, cnt: torch.Tensor,
         col: torch.Tensor, total: torch.Tensor, n: int):
    """K11, second pass: the float32 positive-PMI value of every entry of
    one (cen, ctx)-sorted range, given the int64 column sums and total of
    every range, and the range's CSR row pointer (int64 (n+1,)).  Returns
    ``(vals, indptr)``."""
    name = "ppmi"
    m = cen.shape[0]
    for t in (cen, ctx, cnt):
        _require(t.dtype == torch.int32 and t.shape == (m,),
                 f"{name}: cen, ctx and cnt must be int32 of one 1-D shape")
    _require(col.dtype == torch.int64 and col.shape == (n,)
             and total.dtype == torch.int64 and total.shape == (1,),
             f"{name}: col (n,) and total (1,) must be int64")
    _require_cuda_contiguous(name, cen.device, cen, ctx, cnt, col, total)
    # the kernel writes indptr[cen[i]]: the centers must be sorted, in range
    _require(m == 0 or (int(cen[0]) >= 0 and int(cen[-1]) < n
                        and bool(torch.all(cen[1:] >= cen[:-1]))),
             f"{name}: cen must be non-decreasing node ids below n")
    vals = torch.empty((m,), dtype=torch.float32, device=cen.device)
    indptr = torch.zeros((n + 1,), dtype=torch.int64, device=cen.device)
    with torch.cuda.device(cen.device):
        rc = _bound(name)(cen.data_ptr(), ctx.data_ptr(), cnt.data_ptr(), m,
                          int(n), col.data_ptr(), total.data_ptr(),
                          vals.data_ptr(), indptr.data_ptr(),
                          torch.cuda.current_stream(cen.device).cuda_stream)
    _check_launch(name, rc)
    return vals, indptr


def label_prop(indptr: torch.Tensor, indices: torch.Tensor,
               vals: torch.Tensor, f: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor, alpha: float, beta: float,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K14: one label-propagation step, ``out = where(mask, y, alpha·(A @
    f) + beta·y)`` (A in CSR) on float32 (N, C) ``f`` and ``y`` and bool
    (N,) ``mask``, with alpha and beta rounded to float32.  Writes a new
    tensor, or ``out``, which must not share memory with ``f`` or ``y``.
    Returns it."""
    name = "label_prop"
    n = indptr.shape[0] - 1
    _require_csr(name, indptr, indices, vals)
    for t in (f, y):
        _require(t.dtype == torch.float32 and t.dim() == 2,
                 f"{name}: f and y must be 2-D float32 tensors")
    _require(f.shape == y.shape and f.shape[0] == n,
             f"{name}: f and y must have one row per row of A")
    _require(mask.dtype == torch.bool and mask.shape == (n,),
             f"{name}: mask must be a bool tensor with one entry per row")
    if out is None:
        out = torch.empty_like(f)
    _require(out.dtype == torch.float32 and out.shape == f.shape,
             f"{name}: out must be float32 of the shape of f")
    _require(not _overlap(out, f) and not _overlap(out, y),
             f"{name}: out must not share memory with f or y")
    _require_cuda_contiguous(name, f.device, indptr, indices, vals, f, y,
                             mask, out)
    fn = _bound(name)
    with torch.cuda.device(f.device):
        rc = fn(indptr.data_ptr(), indices.data_ptr(), vals.data_ptr(),
                f.data_ptr(), y.data_ptr(), mask.data_ptr(), out.data_ptr(),
                n, f.shape[1], float(np.float32(alpha)),
                float(np.float32(beta)),
                torch.cuda.current_stream(f.device).cuda_stream)
    _check_launch(name, rc)
    return out


def _dropout_args(name: str, p: float, seed: int, epoch: int, layer: int):
    _require(0.0 <= float(p) <= 1.0, f"{name}: p must lie in [0, 1]")
    _require(0 <= int(epoch) < 1 << 32 and 0 <= int(layer) < 1 << 32,
             f"{name}: epoch and layer must fit 32 bits")
    key = int(seed) & ((1 << 64) - 1)
    return (float(np.float32(p)), float(np.float32(1.0 - float(p))),
            key & _U32, key >> 32, int(epoch), int(layer))


def relu_dropout(z: torch.Tensor, p: float, seed: int, epoch: int,
                 layer: int) -> torch.Tensor:
    """K15, forward: ``keep ? relu(z)/(1−p) : 0`` on float32 ``z`` with the
    Philox mask of (seed, epoch, layer) (``ops/gcn.py``).  Returns a new
    tensor."""
    name = "relu_dropout"
    args = _dropout_args(name, p, seed, epoch, layer)
    _require(z.dtype == torch.float32, f"{name}: z must be float32")
    _require_cuda_contiguous(name, z.device, z)
    h = torch.empty_like(z)
    fn = _bound(name)
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), h.data_ptr(), z.numel(), *args,
                torch.cuda.current_stream(z.device).cuda_stream)
    _check_launch(name, rc)
    return h


def relu_dropout_backward(z: torch.Tensor, dh: torch.Tensor, p: float,
                          seed: int, epoch: int, layer: int) -> torch.Tensor:
    """K15, backward: ``(keep and z > 0) ? dh/(1−p) : 0`` with the mask of
    the forward, drawn again.  Returns a new tensor."""
    name = "relu_dropout"
    args = _dropout_args(name, p, seed, epoch, layer)
    _require(z.dtype == torch.float32 and dh.dtype == torch.float32
             and z.shape == dh.shape,
             f"{name}: z and dh must be float32 of one shape")
    _require_cuda_contiguous(name, z.device, z, dh)
    dz = torch.empty_like(z)
    fn = _bound(name, "relu_dropout_backward")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), dh.data_ptr(), dz.data_ptr(), z.numel(), *args,
                torch.cuda.current_stream(z.device).cuda_stream)
    _check_launch(name, rc)
    return dz


def halo_pack(x: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """K16: the halo send slab ``out[p, m] = x[send_idx[p, m]]``, a new
    (P, M, D) tensor in ``x``'s dtype (float32 or bfloat16).  The indices
    must lie in [0, rows of x): the sharded loop checks its plan on the
    host when it is built."""
    name = "halo_pack"
    _require(x.dtype in (torch.float32, torch.bfloat16) and x.dim() == 2,
             f"{name}: x must be a 2-D float32 or bfloat16 tensor")
    _require(send_idx.dtype == torch.int32 and send_idx.dim() == 2,
             f"{name}: send_idx must be a 2-D int32 tensor")
    _require_cuda_contiguous(name, x.device, x, send_idx)
    p, m = send_idx.shape
    out = torch.empty((p, m, x.shape[1]), dtype=x.dtype, device=x.device)
    row_bytes = x.shape[1] * x.element_size()
    vec = next(v for v in (16, 4, 2)
               if row_bytes % v == 0 and x.data_ptr() % v == 0
               and out.data_ptr() % v == 0)
    fn = _bound(name)
    with torch.cuda.device(x.device):
        rc = fn(send_idx.data_ptr(), x.data_ptr(), out.data_ptr(), p * m,
                row_bytes, vec,
                torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(name, rc)
    return out
