"""ctypes bindings of the port's hand-written CUDA kernels.

K1 ``spmm_csr.cu``, K2 ``row_normalize.cu``, K3 ``hash_init.cu``, K4
``edge_attention.cu``, K5 ``spmm_axpy.cu``, K6 ``dense_markov.cu``, K7
``log_clip.cu``, K8 ``walk_uniform.cu``, K9 ``pair_enum.cu``, K10
``run_length.cu``, K11 ``ppmi.cu``, K12 ``walk_p_q.cu``, K13
``pq_adc.cu``, K14 ``label_prop.cu``, K15 ``relu_dropout.cu``, K16
``halo_pack.cu``, K17 ``walk_owned.cu``, K18 ``walk2_owned.cu`` and K19
``spmm_acc.cu`` are built at first use (:mod:`.build`).  Each wrapper
checks device, dtype, shape and contiguity, launches on PyTorch's current
stream, raises if the launch is refused, and adds one to its entry in
:data:`LAUNCHES`; while :func:`recording` is open (``tracing.trace``) each
launch is bracketed by a pair of CUDA events.  K4's library also holds
the fused attention pass (:func:`attention_spmm`).  The wrappers take CUDA
tensors only; the plain PyTorch versions live beside their callers in
``ops/``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build

# the launch counters: one a kernel library, one for K10's merge form, one
# for the fused attention pass in K4's library and one for K15's backward
COUNTERS = (*build.KERNELS, "run_length_merge", "attention_spmm",
            "relu_dropout_backward")
LAUNCHES = dict.fromkeys(COUNTERS, 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class LaunchLog:
    """The launches made while :func:`recording` is open: ``(entry,
    library, start, end)`` in launch order, where ``entry`` names the
    launch function (``spmm_csr``, ``attention_spmm``, ``spmm_axpy_long``,
    ...), ``library`` its kernel source (``spmm_csr``, ``edge_attention``,
    ...) and ``start``/``end`` are timing CUDA events recorded on the
    launch's stream just before and just after it."""

    def __init__(self) -> None:
        self.launches: List[Tuple[str, str, torch.cuda.Event,
                                  torch.cuda.Event]] = []


_RECORDING: List[LaunchLog] = []  # the open logs


@contextlib.contextmanager
def recording():
    """Record a CUDA event pair around every launch of the port's kernels
    in the block (``tracing.trace`` names the port's kernels in its trace
    from these).  Outside such a block a launch records nothing."""
    log = LaunchLog()
    _RECORDING.append(log)
    try:
        yield log
    finally:
        _RECORDING.remove(log)


def _recorded(library: str, entry: str, fn):
    """``fn`` (the launch function ``entry`` of the kernel library
    ``library``, whose last argument is the stream) with an event pair
    around each call while a :func:`recording` is open."""
    def launch(*args):
        if not _RECORDING:
            return fn(*args)
        stream = torch.cuda.current_stream()
        if stream.cuda_stream != args[-1]:
            stream = torch.cuda.ExternalStream(args[-1])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        rc = fn(*args)
        end.record(stream)
        for log in _RECORDING:
            log.launches.append((entry, library, start, end))
        return rc
    return launch


_c = ctypes
_ARGTYPES = {
    # indptr, indices, vals, x, x_bf16, res, out, n_rows, d, keep, w, norm,
    # vec4, long_slice, item_rows, item_starts, item_cuts, n_items, split,
    # n_split, part, stream
    "spmm_csr": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int,
                 _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_float,
                 _c.c_float, _c.c_int, _c.c_int, _c.c_int64, _c.c_void_p,
                 _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_void_p,
                 _c.c_int64, _c.c_void_p, _c.c_void_p],
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
    # indptr, indices, vals, x, out, n_rows, d, temperature, norm, vec4,
    # long_slice, item_rows, item_starts, item_cuts, n_items, split, n_split,
    # part, stats, stream
    "attention_spmm": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                       _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_float,
                       _c.c_int, _c.c_int, _c.c_int64, _c.c_void_p,
                       _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_void_p,
                       _c.c_int64, _c.c_void_p, _c.c_void_p, _c.c_void_p],
    # indptr, rows, indices, vals, x, self, z, acc, out, n_rows, d, a, b, c,
    # dd, vec4, stream
    "spmm_axpy": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                  _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                  _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_float,
                  _c.c_float, _c.c_float, _c.c_float, _c.c_int, _c.c_void_p],
    # indptr, whole, n_whole, item_rows, item_starts, item_cuts, n_items,
    # split, n_split, indices, vals, x, acc, d, a, dd, vec4, x_rows,
    # band_rows, cursor, part, stream
    "spmm_axpy_long": [_c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_void_p,
                       _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_void_p,
                       _c.c_int64, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                       _c.c_void_p, _c.c_int64, _c.c_float, _c.c_float,
                       _c.c_int, _c.c_int64, _c.c_int64, _c.c_void_p,
                       _c.c_void_p, _c.c_void_p],
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
    # keys, len, n, passes, vec, scratch, out, stream
    "run_length": [_c.c_void_p, _c.c_int64, _c.c_int64, _c.c_int, _c.c_int,
                   _c.c_void_p, _c.c_void_p, _c.c_void_p],
    # cen_a, ctx_a, cnt_a, ma, cen_b, ctx_b, cnt_b, mb, scratch, out, stream
    "run_length_merge": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64,
                         _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64,
                         _c.c_void_p, _c.c_void_p, _c.c_void_p],
    # ctx, cnt, m, col, total, stream
    "ppmi_colsum": [_c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_void_p,
                    _c.c_void_p, _c.c_void_p],
    # cen, ctx, cnt, m, n, col, total, vals, indptr, scratch, stream
    "ppmi": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_int64,
             _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
             _c.c_void_p, _c.c_void_p],
    # indptr, indices, vals, f, y, mask, out, n_rows, c, alpha, beta, stream
    "label_prop": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                   _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64,
                   _c.c_int64, _c.c_float, _c.c_float, _c.c_void_p],
    # z, h, mask, numel, p, q, k0, k1, epoch, layer, stream
    "relu_dropout": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64,
                     _c.c_float, _c.c_float, _c.c_uint32, _c.c_uint32,
                     _c.c_uint32, _c.c_uint32, _c.c_void_p],
    # mask, dh, dz, numel, q, stream
    "relu_dropout_backward": [_c.c_void_p, _c.c_void_p, _c.c_void_p,
                              _c.c_int64, _c.c_float, _c.c_void_p],
    # row_ids, indptr, cols, vals, table, table_bf16, res, acc, n_rows, d,
    # add, keep, w, norm, vec4, long_slice, item_rows, item_starts,
    # item_cuts, n_items, split, n_split, part, stream
    "spmm_acc": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                 _c.c_void_p, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int64,
                 _c.c_int64, _c.c_int, _c.c_float, _c.c_float, _c.c_int,
                 _c.c_int, _c.c_int64, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                 _c.c_int64, _c.c_void_p, _c.c_int64, _c.c_void_p,
                 _c.c_void_p],
    # idx, x, out, n_slots, row_bytes, vec_bytes, stream
    "halo_pack": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64,
                  _c.c_int64, _c.c_int, _c.c_void_p],
    # indptr, cols, deg, frontier, out, batch, hop, base, k0, k1, n, row_lo,
    # rps, root, stream
    "walk_owned": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                   _c.c_void_p, _c.c_int64, _c.c_int, _c.c_int64,
                   _c.c_uint32, _c.c_uint32, _c.c_int32, _c.c_int64,
                   _c.c_int64, _c.c_int, _c.c_void_p],
    # indptr, cols, vals, deg, wmax, wsum, cur, prev, out, shared, batch, hop,
    # base, k0, k1, n, row_lo, rps, inv_p, inv_q, tries, stream
    "walk2_local": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                    _c.c_void_p, _c.c_int, _c.c_int64, _c.c_int, _c.c_int64,
                    _c.c_uint32, _c.c_uint32, _c.c_int32, _c.c_int64,
                    _c.c_int64, _c.c_float, _c.c_float, _c.c_int,
                    _c.c_void_p],
    # indptr, cols, vals, stats, batch, lanes, count, cur, prev, hop, r0,
    # log_r, tries, base, k0, k1, n, row_lo, rps, inv_q, out, stream
    "walk2_propose": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                      _c.c_int64, _c.c_void_p, _c.c_int64, _c.c_void_p,
                      _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                      _c.c_int64, _c.c_uint32, _c.c_uint32, _c.c_int32,
                      _c.c_int64, _c.c_int64, _c.c_float, _c.c_void_p,
                      _c.c_void_p],
    # indptr, cols, deg, stats, batch, lanes, count, prop, prev, hop, r0,
    # log_r, tries, base, k0, k1, n, row_lo, rps, inv_q, out, stream
    "walk2_member": [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                     _c.c_int64, _c.c_void_p, _c.c_int64, _c.c_void_p,
                     _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                     _c.c_int64, _c.c_uint32, _c.c_uint32, _c.c_int32,
                     _c.c_int64, _c.c_int64, _c.c_float, _c.c_void_p,
                     _c.c_void_p],
    # stats, batch, lanes, count, prop, member, prev, hop, r0, log_r, tries,
    # base, k0, k1, n, inv_q, nxt, still, stream
    "walk2_decide": [_c.c_void_p, _c.c_int64, _c.c_void_p, _c.c_int64,
                     _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int,
                     _c.c_int, _c.c_int, _c.c_int64, _c.c_uint32, _c.c_uint32,
                     _c.c_int32, _c.c_float, _c.c_void_p, _c.c_void_p,
                     _c.c_void_p],
}


_BOUND = {}


def _bound(name: str, entry: Optional[str] = None):
    """The launch function ``<entry>_launch`` of kernel library ``name``
    (``entry`` defaults to ``name``; K5, K10 and K11 export two), bound
    once."""
    entry = entry or name
    fn = _BOUND.get(entry)
    if fn is None:
        raw = getattr(build.load(name), f"{entry}_launch")
        raw.restype = ctypes.c_int
        raw.argtypes = _ARGTYPES[entry]
        fn = _BOUND[entry] = _recorded(name, entry, raw)
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


# the widest row that K1 and the fused attention pass normalise in their
# epilogue (one column tile: a warp, 8 float4 slots a lane)
FUSED_NORM_MAX_WIDTH = 1024
_NORMS = {"none": 0, "l2": 1, "l1": 2}
_NO_SLICES = (1 << 63) - 1  # long_slice for "walk every row with its team"


def _hub_args(hubs: Optional["HubPlan"], device, name: str):
    """K1's and the fused pass's hub arguments: (long_slice, item_rows,
    item_starts, item_cuts, n_items, split, n_split) for ctypes."""
    if hubs is None:
        return _NO_SLICES, None, None, None, 0, None, 0
    _require(hubs.item_starts.dtype == torch.int64
             and all(t.dtype == torch.int32 for t in
                     (hubs.item_rows, hubs.item_cuts, hubs.split))
             and hubs.item_rows.shape == hubs.item_starts.shape
             == hubs.item_cuts.shape,
             f"{name}: hubs must be a HubPlan of 1-D int32/int64 tensors")
    _require_cuda_contiguous(name, device, *hubs[:4])
    return (hubs.long_slice, hubs.item_rows.data_ptr(),
            hubs.item_starts.data_ptr(),
            hubs.item_cuts.data_ptr(), hubs.item_rows.shape[0],
            hubs.split.data_ptr(), hubs.split.shape[0])


def spmm_csr(indptr: torch.Tensor, indices: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, residual_weight: float = 0.0,
             residual: Optional[torch.Tensor] = None,
             normalization: str = "none",
             hubs: Optional["HubPlan"] = None) -> torch.Tensor:
    """K1: ``out = A @ x`` (A in CSR), then ``(1-w)·out + w·r`` for w > 0,
    where ``r`` is ``residual`` (default ``x``): the sharded loop gathers
    from a table that is not the shard's own state; then each row divided
    by max(its ``"l2"`` or ``"l1"`` norm, 1e-10) for those
    ``normalization`` modes (D <= :data:`FUSED_NORM_MAX_WIDTH`).  ``hubs``
    (A's :class:`HubPlan`, :func:`hub_plan`) cuts the rows of more than
    :data:`LONG_SLICE` entries into slices; without it every row is walked
    by its own team.  Returns a new float32 (N, D) tensor."""
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
    _require(normalization in _NORMS,
             f"spmm_csr: unknown normalization {normalization}")
    d = x.shape[1]
    _require(normalization == "none" or d <= FUSED_NORM_MAX_WIDTH,
             f"spmm_csr: rows wider than {FUSED_NORM_MAX_WIDTH} are not "
             "normalised in the epilogue")
    w = float(residual_weight)
    hub = _hub_args(hubs, x.device, "spmm_csr")
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    part = None
    if hub[4]:
        part = torch.empty((hub[4], d), dtype=torch.float32, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    align = 8 if bf16 else 16
    vec4 = (d % 4 == 0 and x.data_ptr() % align == 0
            and res.data_ptr() % align == 0)
    fn = _bound("spmm_csr")
    with torch.cuda.device(x.device):
        rc = fn(indptr.data_ptr(), indices.data_ptr(), vals.data_ptr(),
                x.data_ptr(), int(bf16), res.data_ptr(), out.data_ptr(), n, d,
                1.0 - w, w, _NORMS[normalization], int(vec4), *hub,
                None if part is None else part.data_ptr(),
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


def attention_spmm(indptr: torch.Tensor, indices: torch.Tensor,
                   vals: torch.Tensor, x: torch.Tensor, temperature: float,
                   normalization: str = "none",
                   hubs: Optional["HubPlan"] = None) -> torch.Tensor:
    """The fused attention pass (K4's library): for each row of A, the
    attention-weighted propagate of one ``embed_with_attention`` iteration
    of the float32 state ``x`` (cosine scores over T, the row softmax over
    the edges whose value is not 0, reweighting by the value and row
    renormalisation, then the SpMM), and each row divided by max(its
    ``"l2"`` or ``"l1"`` norm, 1e-10) for those ``normalization`` modes.
    D <= :data:`FUSED_NORM_MAX_WIDTH`.  ``hubs`` as for :func:`spmm_csr`.
    Returns a new float32 (N, D) tensor."""
    name = "attention_spmm"
    n = indptr.shape[0] - 1
    _require_csr(name, indptr, indices, vals)
    _require_cuda_contiguous(name, x.device, indptr, indices, vals, x)
    _require(x.dtype == torch.float32 and x.dim() == 2,
             f"{name}: x must be a 2-D float32 tensor")
    _require(x.shape[0] >= n, f"{name}: x has fewer rows than A")
    _require(normalization in _NORMS,
             f"{name}: unknown normalization {normalization}")
    d = x.shape[1]
    _require(d <= FUSED_NORM_MAX_WIDTH,
             f"{name}: rows wider than {FUSED_NORM_MAX_WIDTH} are not "
             "supported")
    hub = _hub_args(hubs, x.device, name)
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    part = stats = None
    if hub[4]:
        part = torch.empty((hub[4], d), dtype=torch.float32, device=x.device)
        stats = torch.empty((hub[4], 3), dtype=torch.float32,
                            device=x.device)
    vec4 = d % 4 == 0 and _aligned16(x, out)
    fn = _bound("edge_attention", name)
    with torch.cuda.device(x.device):
        rc = fn(indptr.data_ptr(), indices.data_ptr(), vals.data_ptr(),
                x.data_ptr(), out.data_ptr(), n, d, float(temperature),
                _NORMS[normalization], int(vec4), *hub,
                None if part is None else part.data_ptr(),
                None if stats is None else stats.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(name, rc)
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


# K5's long-row path, taken on a row plan (the rsvd apply's route) where a
# row is wide enough to give each lane of a warp a float4 and the plan's
# rows hold at least LONG_BAND_ENTRIES entries a band of x on average.  x
# is walked in bands of about BAND_BYTES (the 50 MB L2 keeps a band while
# every row gathers from it: 24 MB was the fastest of 6-48 MB on phase 7's
# rsvd apply), and every row pays for each band (its cursor and its partial
# sums), so the long-row kernel wins only where a row has enough entries in
# each band: on an H100 at width 272 it took 8.0 ms against the short-row
# kernel's 12.4 at 17.6 entries a row a band, and 35.5 against 12.9 at 2.8
# (the crossover near 9).  A row of more than LONG_SLICE entries is cut into
# ceil(entries / LONG_SLICE) slices, a warp each, which take the row's
# chunks of 32 entries in turn.  scripts/torch_count_probe.py measures all
# three.  K1 and the fused attention pass cut the same hub rows (their
# HubPlan) on every call.
LONG_BAND_ENTRIES = 10
LONG_ROW_MIN_WIDTH = 128
BAND_BYTES = 24 << 20
LONG_SLICE = 4096


class HubPlan(NamedTuple):
    """The slices of a CSR's hub rows (more than :data:`LONG_SLICE`
    entries), for K1, the fused attention pass and K5's long-row kernel."""
    item_rows: torch.Tensor    # int32: each slice's row, a row's adjacent
    item_starts: torch.Tensor  # int64: the first entry of each slice's
                               # first chunk of 32
    item_cuts: torch.Tensor    # int32: the slices of each slice's row
    split: torch.Tensor        # int32: the first slice of each cut row
    long_slice: int            # the row length above which a row is cut


def hub_plan(indptr: torch.Tensor) -> HubPlan:
    """The :class:`HubPlan` of a CSR, on its device (one host read of the
    number of slices).  A row of L > LONG_SLICE entries becomes K =
    ceil(L / LONG_SLICE) slices; slice j takes its chunks of 32 entries j,
    j + K, j + 2K, ...  Each row's cut depends on its own length alone, so
    the rows of a shard are cut as in the whole matrix."""
    lengths = indptr[1:] - indptr[:-1]
    cuts = (lengths + LONG_SLICE - 1) // LONG_SLICE
    cut_rows = torch.nonzero(cuts > 1).flatten()
    cuts = cuts[cut_rows]
    item_rows = torch.repeat_interleave(cut_rows, cuts)
    first = torch.cumsum(cuts, 0) - cuts  # each cut row's first slice
    k = (torch.arange(item_rows.shape[0], device=indptr.device)
         - torch.repeat_interleave(first, cuts))
    return HubPlan(item_rows.to(torch.int32), indptr[item_rows] + 32 * k,
                   torch.repeat_interleave(cuts, cuts).to(torch.int32),
                   first.to(torch.int32), LONG_SLICE)


class RowPlan(NamedTuple):
    """The rows of a CSR that hold entries, each with ascending columns,
    and the slices of its long rows for K5's long-row kernel."""
    rows: torch.Tensor         # int32 (m,): the non-empty rows, ascending
    whole: torch.Tensor        # int32: the rows not cut, ascending
    item_rows: torch.Tensor    # int32: the HubPlan's fields
    item_starts: torch.Tensor  # int64
    item_cuts: torch.Tensor    # int32
    split: torch.Tensor        # int32


def row_plan(indptr: torch.Tensor, indices: torch.Tensor,
             hubs: Optional[HubPlan] = None) -> Optional[RowPlan]:
    """The :class:`RowPlan` of a CSR, on its device, or None when some
    row's columns do not ascend: its non-empty rows, those not cut, and
    the :class:`HubPlan` (``hubs``, built here when not given)."""
    if not columns_ascend(indptr, indices):
        return None
    lengths = indptr[1:] - indptr[:-1]
    rows = torch.nonzero(lengths).flatten()
    hubs = hub_plan(indptr) if hubs is None else hubs
    whole = rows[lengths[rows] <= hubs.long_slice]
    return RowPlan(rows.to(torch.int32), whole.to(torch.int32), *hubs[:4])


def spmm_axpy(indptr: torch.Tensor, indices: torch.Tensor, vals: torch.Tensor,
              x: torch.Tensor, a: float, b: float = 0.0,
              z: Optional[torch.Tensor] = None, c: float = 0.0,
              acc: Optional[torch.Tensor] = None, d: float = 0.0,
              self_: Optional[torch.Tensor] = None,
              rows: Optional[RowPlan] = None) -> Optional[torch.Tensor]:
    """K5: ``out = a·(A @ x) + b·s + c·z`` (A in CSR) as a new float32
    (N, D) tensor, and ``acc += d·out`` in place when ``acc`` is given.
    ``s`` is ``self_`` (default ``x``): the sharded siblings gather from a
    table that is not the shard's own rows, and the table may have any
    number of rows.

    ``rows`` (A's :class:`RowPlan`, :func:`row_plan`) touches A's non-empty
    rows only: it needs ``acc``, ``b == 0`` and no ``z`` (a row without
    entries then adds 0 to ``acc``), writes no ``out`` and returns None.
    With a plan whose rows hold at least :data:`LONG_BAND_ENTRIES` entries
    a band of x on average (x cut into bands of :data:`BAND_BYTES`), at a
    width of at least :data:`LONG_ROW_MIN_WIDTH`, the long-row kernel runs,
    which walks x band by band; otherwise the short-row kernel."""
    name = "spmm_axpy"
    n = indptr.shape[0] - 1
    _require_csr(name, indptr, indices, vals)
    s = x if self_ is None else self_
    dense = [t for t in (x, self_, z, acc) if t is not None]
    for t in dense:
        _require(t.dtype == torch.float32 and t.dim() == 2,
                 f"{name}: x, self_, z and acc must be 2-D float32 tensors")
    _require(all(t.shape == s.shape for t in (z, acc) if t is not None)
             and x.shape[1] == s.shape[1],
             f"{name}: x, self_, z and acc shapes differ")
    _require(s.shape[0] == n, f"{name}: x must have one row per row of A"
             if self_ is None else
             f"{name}: self_ must have one row per row of A")
    # the kernel reads x, self_ and z through the read-only cache, and other
    # rows gather x, while a row's thread updates acc
    _require(acc is None or not any(_overlap(acc, t) for t in (x, self_, z)
                                    if t is not None),
             f"{name}: acc must not share memory with x, self_ or z")
    plan = []
    if rows is not None:
        _require(acc is not None and float(b) == 0.0 and z is None,
                 f"{name}: rows needs acc, b == 0 and no z")
        plan = list(rows)
        _require(all(t.dim() == 1 for t in plan)
                 and rows.item_starts.dtype == torch.int64
                 and all(t.dtype == torch.int32 for t in
                         (rows.rows, rows.whole, rows.item_rows,
                          rows.item_cuts, rows.split))
                 and rows.item_rows.shape == rows.item_starts.shape
                 == rows.item_cuts.shape,
                 f"{name}: rows must be a RowPlan of 1-D int32/int64 "
                 "tensors")
    _require_cuda_contiguous(name, x.device, indptr, indices, vals, *dense,
                             *plan)
    width = x.shape[1]
    n_work = n if rows is None else rows.rows.shape[0]
    out = None
    if rows is None:
        out = torch.empty((n, width), dtype=torch.float32, device=x.device)
        dense.append(out)
    vec4 = width % 4 == 0 and _aligned16(*dense)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    band_rows = max(1, BAND_BYTES // (4 * width))
    bands = -(-x.shape[0] // band_rows)
    long_rows = (rows is not None and width >= LONG_ROW_MIN_WIDTH
                 and indices.shape[0]
                 >= LONG_BAND_ENTRIES * bands * max(1, n_work))
    with torch.cuda.device(x.device):
        if not long_rows:
            rc = _bound(name)(
                indptr.data_ptr(),
                None if rows is None else rows.rows.data_ptr(),
                indices.data_ptr(), vals.data_ptr(), x.data_ptr(),
                s.data_ptr(), None if z is None else z.data_ptr(),
                None if acc is None else acc.data_ptr(),
                None if out is None else out.data_ptr(), n_work, width,
                float(a), float(b), float(c), float(d), int(vec4), stream)
        else:
            whole, items = rows.whole.shape[0], rows.item_rows.shape[0]
            work = whole + items
            cursor = part = None
            if bands > 1:
                cursor = torch.empty((work * -(-width // 256),),
                                     dtype=torch.int64, device=x.device)
            if bands > 1 or items:
                part = torch.empty((work, width), dtype=torch.float32,
                                   device=x.device)
            rc = _bound(name, "spmm_axpy_long")(
                indptr.data_ptr(), rows.whole.data_ptr(), whole,
                rows.item_rows.data_ptr(), rows.item_starts.data_ptr(),
                rows.item_cuts.data_ptr(), items, rows.split.data_ptr(),
                rows.split.shape[0], indices.data_ptr(), vals.data_ptr(),
                x.data_ptr(), acc.data_ptr(), width, float(a), float(d),
                int(vec4), x.shape[0], band_rows,
                None if cursor is None else cursor.data_ptr(),
                None if part is None else part.data_ptr(), stream)
            del cursor, part
    _check_launch(name, rc)
    return out


def columns_ascend(indptr: torch.Tensor, indices: torch.Tensor) -> bool:
    """Whether every row's column indices ascend (one pass over them)."""
    if indices.shape[0] < 2:
        return True
    step = indices[1:] >= indices[:-1]
    starts = indptr[1:-1]
    starts = starts[(starts > 0) & (starts < indices.shape[0])]
    step[starts - 1] = True  # a row's first entry follows another row's
    return bool(step.all())


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


_TILE = 2048  # keys (or merged entries) a block of K10 reduces (kTile)


def run_length(keys: torch.Tensor, n: int, passes: int):
    """K10, sweep form: the runs of ascending int64 ``keys`` (INT64_MAX =
    dead, at the end) as int32 ``(cen, ctx, cnt)`` in key order, with
    ``cnt`` the run's length, and int32 ``m_per`` (passes,), the runs of
    each partition.  One launch; the outputs are views of a worst-case
    buffer (one run a key) narrowed to the runs, which costs one read of
    their number by the host."""
    name = "run_length"
    _require(keys.dtype == torch.int64 and keys.dim() == 1,
             f"{name}: keys must be a 1-D int64 tensor")
    _require(1 <= passes < 1 << 31, f"{name}: passes must be at least 1")
    _require(keys.shape[0] < 1 << 31, f"{name}: at most 2^31 - 1 keys")
    _require_cuda_contiguous(name, keys.device, keys)
    dev = keys.device
    length = keys.shape[0]
    tiles = -(-length // _TILE)
    out = torch.empty((3, length), dtype=torch.int32, device=dev)
    # the look-back's status words and tile counter, then the partitions'
    # first runs (zeroed by the launch)
    scratch = torch.empty((tiles + passes + 2,), dtype=torch.int64,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _bound(name)(keys.data_ptr(), length, int(n), int(passes),
                          int(_aligned16(keys)), scratch.data_ptr(),
                          out.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(name, rc)
    bounds = scratch[tiles + 1:]
    # queued before the host waits for the number of runs
    m_per = (bounds[1:] - bounds[:-1]).to(torch.int32)
    m = int(bounds[-1])
    return (*out[:, :m].unbind(0), m_per)


def run_length_merge(a, b):
    """K10, merge form: the union of two count ranges ``(cen, ctx, cnt)``,
    each sorted by (cen, ctx) with unique pairs, as int32 ``(cen, ctx,
    cnt, m)`` sorted by (cen, ctx), a pair of both ranges once with its
    counts summed modulo 2³²: what a sort of the concatenation and the
    sweep form compute, by a merge path instead of a sort.  The outputs
    are views of an ``|a| + |b|``-entry buffer narrowed to the ``m``
    entries (one read of ``m`` by the host)."""
    name = "run_length_merge"
    for t in (*a[:3], *b[:3]):
        _require(t.dtype == torch.int32 and t.dim() == 1,
                 f"{name}: cen, ctx and cnt must be 1-D int32 tensors")
    ma, mb = a[0].shape[0], b[0].shape[0]
    _require(all(t.shape[0] == ma for t in a[:3])
             and all(t.shape[0] == mb for t in b[:3]),
             f"{name}: cen, ctx and cnt of a range differ in length")
    _require(ma + mb < 1 << 31, f"{name}: at most 2^31 - 1 entries")
    dev = a[0].device
    _require_cuda_contiguous(name, dev, *a[:3], *b[:3])
    total = ma + mb
    tiles = -(-total // _TILE)
    out = torch.empty((3, total), dtype=torch.int32, device=dev)
    # status words, tile counter, the merge's length, each tile's split
    scratch = torch.empty((2 * tiles + 3,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _bound("run_length", name)(
            *(t.data_ptr() for t in a[:3]), ma,
            *(t.data_ptr() for t in b[:3]), mb, scratch.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(name, rc)
    m = int(scratch[tiles + 1])
    return (*out[:, :m].unbind(0), m)


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
            total.data_ptr(), _stream(ctx))
    _check_rc(name, rc)


def ppmi(cen: torch.Tensor, ctx: torch.Tensor, cnt: torch.Tensor,
         col: torch.Tensor, total: torch.Tensor, n: int):
    """K11, second pass: the float32 positive-PMI value of every entry of
    one (cen, ctx)-sorted range, given the int64 column sums and total of
    every range, and the range's CSR row pointer (int64 (n+1,)).  Raises
    ValueError (one host read, after the launch) where cen decreases or a
    cen or ctx leaves [0, n).  Returns ``(vals, indptr)``."""
    name = "ppmi"
    m = cen.shape[0]
    for t in (cen, ctx, cnt):
        _require(t.dtype == torch.int32 and t.shape == (m,),
                 f"{name}: cen, ctx and cnt must be int32 of one 1-D shape")
    _require(col.dtype == torch.int64 and col.shape == (n,)
             and total.dtype == torch.int64 and total.shape == (1,),
             f"{name}: col (n,) and total (1,) must be int64")
    _require_cuda_contiguous(name, cen.device, cen, ctx, cnt, col, total)
    dev = cen.device
    vals = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0:
        return vals, torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    indptr = torch.empty((n + 1,), dtype=torch.int64, device=dev)
    scratch = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    ppmi_into(cen, ctx, cnt, col, total, n, vals, indptr, scratch)
    _require(int(scratch[n]) == 0,
             f"{name}: cen must be non-decreasing node ids below n, and ctx "
             "node ids below n")
    return vals, indptr


def ppmi_into(cen: torch.Tensor, ctx: torch.Tensor, cnt: torch.Tensor,
              col: torch.Tensor, total: torch.Tensor, n: int,
              vals: torch.Tensor, indptr: torch.Tensor,
              scratch: torch.Tensor) -> None:
    """K11's launch alone, as :func:`ppmi` makes it once its arguments are
    checked: the values into ``vals`` (float32 (m,)) and the row pointer
    into ``indptr`` (int64 (n+1,)) of a non-empty range.  ``scratch``
    (int64 (n+1,)) must hold zeros; afterwards ``scratch[n]`` is nonzero
    where cen decreases or a cen or ctx leaves [0, n).  Checks nothing
    and reads nothing back."""
    with torch.cuda.device(cen.device):
        rc = _bound("ppmi")(cen.data_ptr(), ctx.data_ptr(), cnt.data_ptr(),
                            cen.shape[0], int(n), col.data_ptr(),
                            total.data_ptr(), vals.data_ptr(),
                            indptr.data_ptr(), scratch.data_ptr(),
                            _stream(cen))
    _check_launch("ppmi", rc)


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


def _keep_scale(name: str, p: float) -> Tuple[float, float]:
    """``(p, 1 − p)`` rounded to float32."""
    _require(0.0 <= float(p) <= 1.0, f"{name}: p must lie in [0, 1]")
    return float(np.float32(p)), float(np.float32(1.0 - float(p)))


def _require_aligned16(name: str, *tensors) -> None:
    _require(all(t.data_ptr() % 16 == 0 for t in tensors),
             f"{name}: operands must start on a 16-byte boundary")


def dropout_mask_words(numel: int) -> int:
    """The int32 words of K15's packed mask for ``numel`` elements."""
    return (int(numel) + 31) // 32


def relu_dropout(z: torch.Tensor, p: float, seed: int, epoch: int,
                 layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15, forward: ``h = bit ? z/(1−p) : 0`` on float32 ``z``, where bit
    is ``keep and z > 0`` with the Philox keep mask of (seed, epoch, layer)
    (``ops/gcn.py``).  Returns new tensors ``h`` and the packed bits: int32
    (:func:`dropout_mask_words`,), bit e % 32 of word e // 32 for flat
    element e."""
    name = "relu_dropout"
    p, q = _keep_scale(name, p)
    _require(0 <= int(epoch) < 1 << 32 and 0 <= int(layer) < 1 << 32,
             f"{name}: epoch and layer must fit 32 bits")
    _require(z.dtype == torch.float32, f"{name}: z must be float32")
    _require_cuda_contiguous(name, z.device, z)
    _require_aligned16(name, z)
    h = torch.empty_like(z)
    mask = torch.empty((dropout_mask_words(z.numel()),), dtype=torch.int32,
                       device=z.device)
    k0, k1 = _seed_words(seed)
    with torch.cuda.device(z.device):
        rc = _bound(name)(z.data_ptr(), h.data_ptr(), mask.data_ptr(),
                          z.numel(), p, q, k0, k1, int(epoch), int(layer),
                          _stream(z))
    _check_launch(name, rc)
    return h, mask


def relu_dropout_backward(mask: torch.Tensor, dh: torch.Tensor,
                          p: float) -> torch.Tensor:
    """K15, backward: ``dz = bit ? dh/(1−p) : 0`` with the forward's packed
    bits ``mask``; draws nothing.  Returns a new tensor.  Counted under
    ``LAUNCHES["relu_dropout_backward"]``."""
    name = "relu_dropout"
    _, q = _keep_scale(name, p)
    _require(dh.dtype == torch.float32, f"{name}: dh must be float32")
    _require(mask.dtype == torch.int32 and mask.dim() == 1
             and mask.shape[0] == dropout_mask_words(dh.numel()),
             f"{name}: mask must be the forward's int32 words for dh's "
             "elements")
    _require_cuda_contiguous(name, dh.device, mask, dh)
    _require_aligned16(name, dh)
    dz = torch.empty_like(dh)
    with torch.cuda.device(dh.device):
        rc = _bound(name, "relu_dropout_backward")(
            mask.data_ptr(), dh.data_ptr(), dz.data_ptr(), dh.numel(), q,
            _stream(dh))
    _check_launch("relu_dropout_backward", rc)
    return dz


def halo_pack(x: torch.Tensor, send_idx: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K16: the halo send slab ``out[p, m] = x[send_idx[p, m]]``, a
    (P, M, D) tensor in ``x``'s dtype (float32 or bfloat16): ``out`` when
    given (a buffer the caller reuses), else a new one.  The indices must
    lie in [0, rows of x): the sharded loop checks its plan on the host
    when it is built."""
    name = "halo_pack"
    _require(x.dtype in (torch.float32, torch.bfloat16) and x.dim() == 2,
             f"{name}: x must be a 2-D float32 or bfloat16 tensor")
    _require(send_idx.dtype == torch.int32 and send_idx.dim() == 2,
             f"{name}: send_idx must be a 2-D int32 tensor")
    _require_cuda_contiguous(name, x.device, x, send_idx)
    p, m = send_idx.shape
    if out is None:
        out = torch.empty((p, m, x.shape[1]), dtype=x.dtype, device=x.device)
    _require(out.shape == (p, m, x.shape[1]) and out.dtype == x.dtype,
             f"{name}: out must be a ({p}, {m}, {x.shape[1]}) tensor of x's "
             "dtype")
    _require_cuda_contiguous(name, x.device, out)
    _require(not _overlap(out, x), f"{name}: out must not share memory with x")
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


def spmm_acc_(acc: torch.Tensor, row_ids: Optional[torch.Tensor],
              indptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
              table: torch.Tensor, write: bool = False,
              residual_weight: float = 0.0,
              residual: Optional[torch.Tensor] = None,
              normalization: str = "none",
              hubs: Optional["HubPlan"] = None) -> torch.Tensor:
    """K19, one round of the overlapped halo exchange, in place on float32
    (rows, D) ``acc``: each row's ``Σ_e vals[e]·table[cols[e]]`` over its
    edges ``e`` (``indptr``) written into ``acc`` (``write``) or added to
    it, then ``(1-w)·acc + w·residual`` for w > 0, then each row divided by
    max(its ``"l2"`` or ``"l1"`` norm, 1e-10) for those ``normalization``
    modes (D <= :data:`FUSED_NORM_MAX_WIDTH`).  The view's row ``i`` is
    row ``row_ids[i]`` of ``acc`` (distinct ids, in [0, rows of acc)), or
    row ``i`` when ``row_ids`` is None: a view of every row, which the
    write, the residual and the normalisation need.  ``table`` is float32
    or bfloat16 (T, D), its cols in [0, T): the sharded loop checks its
    plan on the host when it is built; ``residual`` (rows, D) has
    ``table``'s dtype.  ``hubs`` (the view's :class:`HubPlan`) cuts its
    rows of more than :data:`LONG_SLICE` entries into slices.  A view with
    no rows launches nothing.  Returns ``acc``."""
    name = "spmm_acc_"
    _require_csr(name, indptr, cols, vals)
    n = indptr.shape[0] - 1
    _require(row_ids is None or (row_ids.dtype == torch.int32
                                 and row_ids.dim() == 1
                                 and row_ids.shape[0] == n),
             f"{name}: row_ids must be int32 with one id per compact row")
    _require(acc.dtype == torch.float32 and acc.dim() == 2,
             f"{name}: acc must be a 2-D float32 tensor")
    _require(table.dtype in (torch.float32, torch.bfloat16)
             and table.dim() == 2 and table.shape[1] == acc.shape[1],
             f"{name}: table must be a 2-D float32 or bfloat16 tensor of "
             "acc's width")
    w = float(residual_weight)
    _require(normalization in _NORMS,
             f"{name}: unknown normalization {normalization}")
    _require(row_ids is not None or n == acc.shape[0],
             f"{name}: a view without row_ids must list every row of acc")
    _require(row_ids is None or not (write or w > 0.0
                                     or normalization != "none"),
             f"{name}: write, the residual and the normalisation need a "
             "view of every row (row_ids=None)")
    _require(w == 0.0 or (residual is not None
                          and residual.dtype == table.dtype
                          and residual.shape == acc.shape),
             f"{name}: residual must be acc's shape in table's dtype")
    d = acc.shape[1]
    _require(normalization == "none" or d <= FUSED_NORM_MAX_WIDTH,
             f"{name}: rows wider than {FUSED_NORM_MAX_WIDTH} are not "
             "normalised in the epilogue")
    res = residual if w > 0.0 else table
    ops = [indptr, cols, vals, table, acc, res]
    _require_cuda_contiguous(name, acc.device,
                             *ops, *([] if row_ids is None else [row_ids]))
    # other rows gather the table through the read-only cache while a
    # row's team updates acc
    _require(not _overlap(acc, table) and not _overlap(acc, res),
             f"{name}: acc must not share memory with table or residual")
    if n == 0 or d == 0:
        return acc
    hub = _hub_args(hubs, acc.device, name)
    part = None
    if hub[4]:
        part = torch.empty((hub[4], d), dtype=torch.float32, device=acc.device)
    bf16 = table.dtype == torch.bfloat16
    align = 8 if bf16 else 16
    vec4 = (d % 4 == 0 and table.data_ptr() % align == 0
            and res.data_ptr() % align == 0 and _aligned16(acc))
    fn = _bound("spmm_acc")
    with torch.cuda.device(acc.device):
        rc = fn(None if row_ids is None else row_ids.data_ptr(),
                indptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                table.data_ptr(), int(bf16), res.data_ptr(), acc.data_ptr(),
                n, d, int(not write), 1.0 - w, w, _NORMS[normalization],
                int(vec4), *hub, None if part is None else part.data_ptr(),
                _stream(acc))
    _check_launch("spmm_acc", rc)
    return acc


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _seed_words(seed: int):
    key = int(seed) & ((1 << 64) - 1)
    return key & _U32, key >> 32


def _require_int32_rows(name: str, t: torch.Tensor, rows: int,
                        width: int) -> None:
    _require(t.dtype == torch.int32 and t.numel() == rows * width
             and t.shape[-1] == width,
             f"{name}: an int32 buffer of {rows} x {width} expected")


def walk_owned(indptr: torch.Tensor, cols: torch.Tensor, deg: torch.Tensor,
               frontier: torch.Tensor, hop: int, seed: int, base: int,
               n: int, row_lo: int, root: bool,
               out: torch.Tensor) -> torch.Tensor:
    """K17: this rank's share of hop ``hop`` of the first-order walks over
    its slice of the row-sharded walk CSR (``indptr`` local row starts and
    ``deg``: int32 (rps,); ``cols`` int32), for the lanes at ``frontier``
    (int32 (B,); lane b is walk ``base + b``), written into ``out`` (int32
    (B,)), which is returned: K8's next node for the lanes whose row the
    rank owns (rows ``[row_lo, row_lo + rps)``), the sentinel ``n`` for a
    lane at the sentinel when ``root``, 0 otherwise.  The slice must be
    valid (``ops/walk.py:ShardedWalkTables`` checks it once)."""
    name = "walk_owned"
    for t in (indptr, cols, deg, frontier, out):
        _require(t.dtype == torch.int32 and t.dim() == 1,
                 f"{name}: int32 1-D tables, frontier and out expected")
    _require(indptr.shape == deg.shape and frontier.shape == out.shape,
             f"{name}: indptr/deg and frontier/out must match")
    _require(hop >= 0 and base >= 0 and row_lo >= 0,
             f"{name}: hop, base and row_lo must be >= 0")
    _require_cuda_contiguous(name, frontier.device, indptr, cols, deg,
                             frontier, out)
    k0, k1 = _seed_words(seed)
    with torch.cuda.device(frontier.device):
        rc = _bound(name)(
            indptr.data_ptr(), cols.data_ptr(), deg.data_ptr(),
            frontier.data_ptr(), out.data_ptr(), frontier.shape[0], int(hop),
            int(base), k0, k1, int(n), int(row_lo), indptr.shape[0],
            int(bool(root)), _stream(frontier))
    _check_launch(name, rc)
    return out


_WALK2 = "walk2_owned"
# the most rounds of a chunk: a lane's membership bits are one int32
WALK2_MAX_CHUNK = 32


def _require_weighted_slice(name: str, indptr, cols, vals, deg, wmax,
                            wsum) -> None:
    for t in (indptr, cols, deg):
        _require(t.dtype == torch.int32 and t.dim() == 1,
                 f"{name}: int32 1-D indptr, cols and deg expected")
    for t in (vals, wmax, wsum):
        _require(t.dtype == torch.float32 and t.dim() == 1,
                 f"{name}: float32 1-D vals, wmax and wsum expected")
    _require(indptr.shape == deg.shape == wmax.shape == wsum.shape
             and vals.shape == cols.shape, f"{name}: table shapes disagree")


def _require_chunk(name: str, lanes: torch.Tensor, stats: torch.Tensor,
                   prev: torch.Tensor, r0: int, chunk: int,
                   tries: int) -> int:
    """Checks a chunk's lanes, summed stats and rounds; returns log2 of the
    chunk's round count."""
    b = prev.shape[0]
    _require(prev.dtype == torch.int32 and prev.dim() == 1,
             f"{name}: prev must be a 1-D int32 tensor")
    _require(lanes.dtype == torch.int32 and lanes.dim() == 1
             and lanes.shape[0] <= b,
             f"{name}: lanes must be a 1-D int32 tensor of at most {b} "
             "lane ids")
    _require_int32_rows(name, stats, 3, b)
    _require(0 < chunk <= WALK2_MAX_CHUNK and chunk & (chunk - 1) == 0,
             f"{name}: the chunk must be a power of two of at most "
             f"{WALK2_MAX_CHUNK} rounds")
    _require(0 <= r0 < tries, f"{name}: the chunk must start below tries")
    return chunk.bit_length() - 1


def walk2_local(indptr, cols, vals, deg, wmax, wsum, cur: torch.Tensor,
                prev: torch.Tensor, hop: int, seed: int, base: int, n: int,
                row_lo: int, inv_p: float, inv_q: float, tries: int,
                out: torch.Tensor) -> torch.Tensor:
    """K18, the local stage of hop ``hop`` over this rank's slice, for the
    lanes at ``cur`` (int32 (B,); ``prev`` the node before, the sentinel
    ``n`` on the first hop; lane b is walk ``base + b``).  With ``out``
    (4, B) int32, for the lanes whose current row the slice owns: row 0
    holds next + 1 for a lane the slice resolves (the first hop, ``prev``
    also in the slice, a row of degree 0 or a dead row: K12's whole hop)
    and 0 for a cross lane, whose degree, ``wmax`` and backtrack weight
    rows 1-3 hold (floats by their bits); 0 for the other lanes.  With
    ``out`` (B,) the slice must hold every row, and the next nodes (the
    sentinel for a pad lane) are written there.  Returns ``out``.  The
    slice must be valid (``ShardedWalkTables``)."""
    name = _WALK2
    _require_weighted_slice(name, indptr, cols, vals, deg, wmax, wsum)
    _require(cur.dtype == prev.dtype == torch.int32 and cur.dim() == 1
             and cur.shape == prev.shape,
             f"{name}: int32 1-D cur and prev of one shape expected")
    b = cur.shape[0]
    shared = out.dim() == 2
    if shared:
        _require_int32_rows(name, out, 4, b)
    else:
        _require_int32_rows(name, out, 1, b)
        _require(row_lo == 0 and indptr.shape[0] >= n,
                 f"{name}: a (B,) out needs a slice that holds every row")
    _require(hop >= 0 and base >= 0 and row_lo >= 0 and tries >= 1,
             f"{name}: hop, base and row_lo must be >= 0, tries >= 1")
    _require_cuda_contiguous(name, cur.device, indptr, cols, vals, deg, wmax,
                             wsum, cur, prev, out)
    _require(not _overlap(out, cur) and not _overlap(out, prev),
             f"{name}: out must not share memory with cur or prev")
    k0, k1 = _seed_words(seed)
    with torch.cuda.device(cur.device):
        rc = _bound(_WALK2, "walk2_local")(
            indptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            deg.data_ptr(), wmax.data_ptr(), wsum.data_ptr(), cur.data_ptr(),
            prev.data_ptr(), out.data_ptr(), int(shared), b, int(hop),
            int(base), k0, k1, int(n), int(row_lo), indptr.shape[0],
            float(np.float32(inv_p)), float(np.float32(inv_q)), int(tries),
            _stream(cur))
    _check_launch(name, rc)
    return out


def walk2_propose(indptr, cols, vals, stats: torch.Tensor,
                  lanes: torch.Tensor, cur: torch.Tensor, prev: torch.Tensor,
                  hop: int, r0: int, chunk: int, tries: int, seed: int,
                  base: int, n: int, row_lo: int, inv_q: float,
                  out: torch.Tensor) -> torch.Tensor:
    """K18, the proposals of rounds ``r0 .. r0 + chunk - 1`` (those below
    ``tries``) of the cross lanes ``lanes`` (int32, ascending) from the
    summed ``stats`` ((3, B): degree, wmax, backtrack weight): for each
    lane whose current row this slice holds and each round that does not
    take the backtrack edge, the proposal and its weight (by its bits) into
    ``out`` ((2, len(lanes)·chunk) int32, lane-major), 0 elsewhere.
    Returns ``out``."""
    name = _WALK2
    log_r = _require_chunk(name, lanes, stats, prev, r0, chunk, tries)
    _require(indptr.dtype == cols.dtype == cur.dtype == torch.int32
             and vals.dtype == torch.float32 and vals.shape == cols.shape
             and cur.shape == prev.shape,
             f"{name}: int32 tables and cur, float32 vals expected")
    count = lanes.shape[0]
    _require_int32_rows(name, out, 2, count * chunk)
    _require_cuda_contiguous(name, cur.device, indptr, cols, vals, stats,
                             lanes, cur, prev, out)
    k0, k1 = _seed_words(seed)
    with torch.cuda.device(cur.device):
        rc = _bound(_WALK2, "walk2_propose")(
            indptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            stats.data_ptr(), cur.shape[0], lanes.data_ptr(), count,
            cur.data_ptr(), prev.data_ptr(), int(hop), int(r0), log_r,
            int(tries), int(base), k0, k1, int(n), int(row_lo),
            indptr.shape[0], float(np.float32(inv_q)), out.data_ptr(),
            _stream(cur))
    _check_launch(name, rc)
    return out


def walk2_member(indptr, cols, deg, stats: torch.Tensor, lanes: torch.Tensor,
                 prop: torch.Tensor, prev: torch.Tensor, hop: int, r0: int,
                 chunk: int, tries: int, seed: int, base: int, n: int,
                 row_lo: int, inv_q: float,
                 out: torch.Tensor) -> torch.Tensor:
    """K18, the common-neighbour tests of a chunk: for each cross lane
    whose previous row this slice holds, bit j of ``out[i]`` ((len(lanes),)
    int32) is 1 when round ``r0 + j`` tests its summed proposal (``prop``:
    not the backtrack edge, not ``prev`` itself, not the last round) and
    the proposal is in ``prev``'s row; 0 elsewhere.  Returns ``out``."""
    name = _WALK2
    log_r = _require_chunk(name, lanes, stats, prev, r0, chunk, tries)
    _require(indptr.dtype == cols.dtype == deg.dtype == torch.int32
             and indptr.shape == deg.shape,
             f"{name}: int32 indptr, cols and deg expected")
    count = lanes.shape[0]
    _require_int32_rows(name, prop, 2, count * chunk)
    _require_int32_rows(name, out, 1, count)
    _require_cuda_contiguous(name, prev.device, indptr, cols, deg, stats,
                             lanes, prop, prev, out)
    k0, k1 = _seed_words(seed)
    with torch.cuda.device(prev.device):
        rc = _bound(_WALK2, "walk2_member")(
            indptr.data_ptr(), cols.data_ptr(), deg.data_ptr(),
            stats.data_ptr(), prev.shape[0], lanes.data_ptr(), count,
            prop.data_ptr(), prev.data_ptr(), int(hop), int(r0), log_r,
            int(tries), int(base), k0, k1, int(n), int(row_lo),
            indptr.shape[0], float(np.float32(inv_q)), out.data_ptr(),
            _stream(prev))
    _check_launch(name, rc)
    return out


def walk2_decide(stats: torch.Tensor, lanes: torch.Tensor, prop: torch.Tensor,
                 member: torch.Tensor, prev: torch.Tensor, hop: int, r0: int,
                 chunk: int, tries: int, seed: int, base: int, n: int,
                 inv_q: float, nxt: torch.Tensor) -> torch.Tensor:
    """K18, the decisions of a chunk from the summed proposals and
    membership bits, the same on every rank: each cross lane takes the
    first of its rounds that hits, in K12's order, and writes its node
    into ``nxt`` (int32 (B,)).  Returns a bool mask of the lanes of
    ``lanes`` still pending."""
    name = _WALK2
    log_r = _require_chunk(name, lanes, stats, prev, r0, chunk, tries)
    count = lanes.shape[0]
    _require(nxt.dtype == torch.int32 and nxt.shape == prev.shape,
             f"{name}: nxt must be int32 of prev's shape")
    _require_int32_rows(name, prop, 2, count * chunk)
    _require_int32_rows(name, member, 1, count)
    _require_cuda_contiguous(name, prev.device, stats, lanes, prop, member,
                             prev, nxt)
    still = torch.empty((count,), dtype=torch.bool, device=prev.device)
    k0, k1 = _seed_words(seed)
    with torch.cuda.device(prev.device):
        rc = _bound(_WALK2, "walk2_decide")(
            stats.data_ptr(), prev.shape[0], lanes.data_ptr(), count,
            prop.data_ptr(), member.data_ptr(), prev.data_ptr(), int(hop),
            int(r0), log_r, int(tries), int(base), k0, k1, int(n),
            float(np.float32(inv_q)), nxt.data_ptr(), still.data_ptr(),
            _stream(prev))
    _check_launch(name, rc)
    return still
