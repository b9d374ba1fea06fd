"""Sibling embedding algorithms on the same sparse-transition substrate.

Counterpart of cleora_tpu/algorithms.py:1-1118, with the same names: ProNE
(Chebyshev filters of the normalized Laplacian), RandNE (iterated random
projection), HOPE (Katz proximity SVD), NetMF (log-PMI matrix
factorization) and GraRep (k-step log-transition SVDs).  ``backend="host"``
(the default) computes in float64 with numpy/scipy and L2-normalizes to
float32, like the reference.

The default is the one deliberate exception to the port's rule that an
entry point runs on the card unless the caller asks for the CPU: the five
signatures and defaults are the JAX package's, where ``backend="host"`` is
the reference's own float64 algorithm and what the device backends are
measured against.  It is a path of its own, chosen by the caller and never
fallen back to: it touches no device and ignores ``device=``, and a
``backend="device"`` call that finds no card raises instead of taking it.

``backend="device"`` runs on the card in float32 (``device=None`` means
CUDA; ``device="cpu"`` runs the kernels' plain PyTorch versions; without a
card and without ``device="cpu"`` it raises).  ProNE, RandNE and HOPE are
loops of kernel K5 (``kernels/spmm_axpy.cu``: the SpMM fused with the
step's elementwise tail) over the CSR in original row order; HOPE is a
matrix-free randomized SVD of the Katz operator that never materializes
the n×n proximity matrix.  NetMF and GraRep apply an elementwise log to a
dense n×n matrix by construction: the dense transition matrix is kernel K6
(``kernels/dense_markov.cu``), its powers are full-float32
``torch.matmul`` products, the log-clip is kernel K7
(``kernels/log_clip.cu``) and the factorization a randomized SVD.  They are
gated by a device-memory fit check (six (n, n) float32 buffers against 90 %
of the card's free memory); past the gate, or with ``block_rows=``, a
blocked path materializes one row block of the log matrix at a time.

The walk-based siblings (cleora_tpu/algorithms.py:1122-3024): DeepWalk
and Node2Vec run on the card as walks (kernel K8,
``kernels/walk_uniform.cu``, for DeepWalk and Node2Vec with ``p == q ==
1``; kernel K12, ``kernels/walk_p_q.cu``, the second-order p/q walk, for
any other p, q), co-occurrence counts on the host or on the card (kernels
K9 ``pair_enum.cu``, ``torch.sort`` and K10 ``run_length.cu``, whose merge
form chain-merges the partitions without a sort, ``ops/cooccur.py``), the
PPMI transform (K11 ``ppmi.cu``) and a randomized SVD whose products are
K5 over each piece's own rows.  Over a shard group the walk tables may
be cut by rows (kernels K17 ``walk_owned.cu`` and K18 ``walk2_owned.cu``,
the owner-routed hops), the counts stay on the rank that counted them and
the factorization may run there (``parallel/cooccur.py``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ._util import full_float32_matmul, resolve_device
from .native import sort_u64
from .ops import memory
from .ops.cooccur import CountCheckpoint, device_pair_counts, ppmi_csrs
from .ops.dense import (
    dense_markov,
    log_clip,
    log_clip_bands,
    rsvd_sparse,
    rsvd_u_sqrt,
)
from .ops.spmm import (
    CsrMatrix,
    one_hot_bands,
    panel_band,
    spmm_axpy,
    spmm_bands,
)
from .ops.walk import (
    WALK_BATCH,
    ShardedWalkTables,
    WalkTables,
    WalkTables2,
    device_walks,
    device_walks2,
    walk2_tries,
)

def _adjacency(graph):
    """Left-Markov CSR as float64 scipy (reference algorithms.py:6-19)."""
    from scipy.sparse import csr_matrix

    rows, cols, vals, n, _ = graph.to_sparse_csr()
    return csr_matrix(
        (vals.astype(np.float64), (rows.astype(np.int32), cols.astype(np.int32))),
        shape=(n, n),
    )


def _sym_normalized(A):
    """D^-1/2 A D^-1/2 and the degree vector."""
    from scipy.sparse import diags

    degrees = np.maximum(np.asarray(A.sum(axis=1)).ravel(), 1e-10)
    D_inv_sqrt = diags(1.0 / np.sqrt(degrees))
    return D_inv_sqrt @ A @ D_inv_sqrt, degrees


def _dense(x):
    return x.toarray() if hasattr(x, "toarray") else np.asarray(x)


def _finalize(result: np.ndarray, feature_dim: int) -> np.ndarray:
    """Pad/truncate to feature_dim and L2-normalize to float32."""
    n = result.shape[0]
    if result.shape[1] > feature_dim:
        result = result[:, :feature_dim]
    elif result.shape[1] < feature_dim:
        result = np.concatenate(
            [result, np.zeros((n, feature_dim - result.shape[1]), result.dtype)],
            axis=1,
        )
    norms = np.maximum(np.linalg.norm(result, axis=1, keepdims=True), 1e-10)
    return (result / norms).astype(np.float32)


def _fetch_f64(t: torch.Tensor) -> np.ndarray:
    """Device→host copy of an algorithm result, then float64."""
    return t.cpu().numpy().astype(np.float64)


def _svd_sqrt(M: np.ndarray, k: int) -> np.ndarray:
    """U_k · sqrt(S_k) — the shared factorization epilogue."""
    u, s, _ = np.linalg.svd(M, full_matrices=False)
    k = min(k, u.shape[1])
    return u[:, :k] * np.sqrt(np.maximum(s[:k], 0))


def _write_npy(emb: np.ndarray, path: str):
    """Persist a host-resident embedding as ``path`` (.npy, atomic) and
    return the read-only memmap, so ``out=`` has one contract everywhere."""
    tmp = path + ".tmp"
    mm = np.lib.format.open_memmap(
        tmp, mode="w+", dtype=np.float32, shape=emb.shape)
    mm[:] = emb
    mm.flush()
    del mm
    os.replace(tmp, path)
    return np.load(path, mmap_mode="r")


# ------------------------------------------------------------------- device
def _sym_normalized_vals(rows, cols, vals, n: int) -> np.ndarray:
    """The values of D^-1/2 A D^-1/2, normalised in float64 on the host and
    rounded to float32 once (cleora_tpu/algorithms.py:155-162, :239-245)."""
    rows64 = rows.astype(np.int64)
    vals64 = vals.astype(np.float64)
    deg = np.zeros(n, dtype=np.float64)
    np.add.at(deg, rows64, vals64)
    dis = 1.0 / np.sqrt(np.maximum(deg, 1e-10))
    return (dis[rows64] * vals64 * dis[cols.astype(np.int64)]).astype(
        np.float32)


def _device_weighted_sum_core(graph, R: np.ndarray, weights: List[float],
                              sym_norm: bool, device=None) -> torch.Tensor:
    """Device half of :func:`_device_spmm_weighted_sum`: the result as a
    float32 tensor still on the device, in original row order."""
    dev = resolve_device(device)
    rows, cols, vals, n, _ = graph.to_sparse_csr()
    # the loop holds (acc, x) plus the SpMM output — the embed-loop
    # estimate (4 N·D f32 arrays + edges) upper-bounds it
    memory.check_device_fit(n, R.shape[1], rows.shape[0], device=dev)
    if sym_norm:
        vals = _sym_normalized_vals(rows, cols, vals, n)
    csr = CsrMatrix.from_coo(rows, cols, vals, n, dev)
    w = np.asarray(weights, dtype=np.float32)
    x = torch.from_numpy(R.astype(np.float32)).to(dev)
    acc = float(w[0]) * x
    for wi in w[1:]:
        x = spmm_axpy(csr, x, 1.0, acc=acc, d=float(wi))
    return acc


def _device_spmm_weighted_sum(graph, R: np.ndarray, weights: List[float],
                              sym_norm: bool, device=None) -> np.ndarray:
    """Σ_i weights[i] · N^i · R on the device (N = adjacency, optionally
    D^-1/2 A D^-1/2): one launch of kernel K5 per power."""
    return _fetch_f64(
        _device_weighted_sum_core(graph, R, weights, sym_norm, device))


def _prone_chebyshev_core(graph, feature_dim: int, mu: float, theta: float,
                          seed: int, device=None) -> torch.Tensor:
    """Device half of ProNE: Chebyshev filtering T_k(L)·R (L@X = X - N@X,
    N = D^-1/2 A D^-1/2), one launch of kernel K5 per term.  Returns the
    float32 result still on the device, in original row order."""
    dev = resolve_device(device)
    n = graph.num_entities
    rows, cols, vals, _, _ = graph.to_sparse_csr()
    # Chebyshev keeps (U, prev, curr) + the SpMM output — bounded by
    # the embed-loop estimate (4 N·D f32 arrays + edges)
    memory.check_device_fit(n, feature_dim, rows.shape[0], device=dev)
    csr = CsrMatrix.from_coo(
        rows, cols, _sym_normalized_vals(rows, cols, vals, n), n, dev)

    rng = np.random.default_rng(seed)
    R = torch.from_numpy(
        rng.standard_normal((n, feature_dim)).astype(np.float32)).to(dev)
    U = R.clone()
    prev = R
    curr = spmm_axpy(csr, R, -1.0, 1.0)  # L·R = R − N·R
    theta32, mu32 = np.float32(theta), np.float32(mu)
    for k in range(2, min(10, n)):
        coeff = float(np.exp(-theta32 * np.float32(k)) * mu32)
        # nxt = 2·L·curr − prev; U += coeff·nxt
        nxt = spmm_axpy(csr, curr, -2.0, 2.0, z=prev, c=-1.0, acc=U, d=coeff)
        prev, curr = curr, nxt
    return U


def _katz(csr: CsrMatrix, x: torch.Tensor, beta: float,
          terms: int) -> torch.Tensor:
    """Σ_{k=1..terms} β^k A^k x, one launch of kernel K5 per term."""
    # row-major: the Q of a CUDA QR comes back column-major
    acc = torch.zeros_like(x, memory_format=torch.contiguous_format)
    cur = x
    for _ in range(terms):
        cur = spmm_axpy(csr, cur, beta, acc=acc, d=1.0)
    return acc


@full_float32_matmul()
def _hope_device(graph, feature_dim: int, beta: float, seed: int,
                 oversample: int, power_iters: int, device=None) -> np.ndarray:
    """Device half of HOPE: sizes the Neumann series from the ∞-norm bound
    and runs the matrix-free randomized SVD of the Katz operator
    M = (I − βA)^{-1} − I = Σ_{k≥1} β^k A^k on the device.  A and Aᵀ are
    both CSRs in original row space, so M and Mᵀ compose directly."""
    dev = resolve_device(device)
    rows, cols, vals, n, _ = graph.to_sparse_csr()
    rows = rows.astype(np.int32)
    cols = cols.astype(np.int32)
    vals = vals.astype(np.float32)

    row_sums = np.zeros(n, dtype=np.float64)
    np.add.at(row_sums, rows.astype(np.int64), np.abs(vals.astype(np.float64)))
    beta_norm = beta * float(row_sums.max(initial=0.0))
    if beta_norm >= 1.0:
        raise ValueError(
            f"backend='device' needs beta * ||A||_inf < 1 for the Neumann "
            f"series to converge (got {beta_norm:.3f}); use backend='host' "
            f"or a smaller beta"
        )
    # β^terms ≤ 1e-12 → truncation error below f32 resolution
    terms = (
        int(np.ceil(np.log(1e-12) / np.log(beta_norm))) if beta_norm > 0 else 1
    )
    terms = max(2, min(terms, 128))

    k = min(feature_dim // 2, n - 1)
    r = min(n, k + oversample)
    # live set ≈ Y/Q/C + the series' carry: ~6 (n, r) f32 buffers
    memory.check_device_fit(n, max(1, (3 * r) // 2), rows.shape[0], device=dev)

    csr_a = CsrMatrix.from_coo(rows, cols, vals, n, dev)
    csr_t = CsrMatrix.transpose_from_coo(rows, cols, vals, n, dev)

    rng = np.random.default_rng(seed)
    omega = torch.from_numpy(
        rng.standard_normal((n, r)).astype(np.float32)).to(dev)

    Y = _katz(csr_a, omega, beta, terms)
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(Y)
        Y = _katz(csr_a, _katz(csr_t, Q, beta, terms), beta, terms)
    Q, _ = torch.linalg.qr(Y)
    C = _katz(csr_t, Q, beta, terms)  # (n, r); Cᵀ = Qᵀ·M
    Ub, s, Vt = torch.linalg.svd(C.T, full_matrices=False)
    su = torch.sqrt(torch.clamp_min(s[:k], 0.0))
    out = torch.cat([torch.matmul(Q, Ub[:, :k]) * su, Vt[:k].T * su], dim=1)
    return _fetch_f64(out)


# --------------------------------------- device dense log-factorization core
def _check_dense_fit(n: int, n_bufs: int = 6, limit=None,
                     device: Optional[torch.device] = None):
    """The dense device factorizations hold ~n_bufs (n, n) f32 buffers live
    (A/P, P^k, accumulator, M_log, rsvd temporaries).  Refuse shapes that
    cannot fit rather than dying in the allocator.  ``limit`` overrides
    the live budget of ``device`` (no budget on the CPU)."""
    if os.environ.get("CLEORA_TPU_SKIP_FIT_CHECK") == "1":
        return
    if limit is None and device is not None:
        limit = memory.device_memory_limit(device)
    if limit is None:
        return
    need = n_bufs * n * n * 4
    if need > int(limit * 0.9):
        gib = 1 << 30
        raise ValueError(
            f"backend='device' builds dense (n, n) transition powers: "
            f"n={n} needs ~{need / gib:.1f} GiB HBM (> {limit / gib:.1f} GiB "
            f"available). Use backend='host' (unbounded, f64) for graphs "
            f"this large."
        )


def _dense_fits(n: int, n_bufs: int = 6, limit=None,
                device: Optional[torch.device] = None) -> bool:
    """True when the dense (n, n) device factorization fits the device."""
    try:
        _check_dense_fit(n, n_bufs, limit=limit, device=device)
        return True
    except ValueError:
        return False


def _coo_f32(graph):
    rows, cols, vals, n, _ = graph.to_sparse_csr()
    return (
        rows.astype(np.int32), cols.astype(np.int32),
        vals.astype(np.float32), n,
    )


@full_float32_matmul()
def _netmf_dense(csr: CsrMatrix, omega: torch.Tensor, neg: float, window: int,
                 k: int, power_iters: int) -> torch.Tensor:
    """Dense NetMF (cleora_tpu/algorithms.py:421-431): kernel K6, the
    window of transition powers as float32 matmuls, the log-PMI clip as
    kernel K7 on the accumulator, randomized SVD."""
    P, deg, vol = dense_markov(csr)
    acc, Pk = P.clone(), P
    for _ in range(window - 1):
        Pk = torch.matmul(Pk, P)
        acc += Pk
    del Pk, P
    # (vol/neg)·((acc/window)/deg_i)·deg_j, the row factor taken in float32
    row_scale = (vol.float() / (neg * window)) / deg
    M_log = log_clip(acc, row_scale, deg, 1.0, 0.0)
    return rsvd_u_sqrt(M_log, omega, k, power_iters)


# log(1e-10) in float32, GraRep's shift (cleora_tpu/algorithms.py:460)
_GRAREP_FLOOR = 1e-10
_GRAREP_OFFSET = float(np.log(np.float32(_GRAREP_FLOOR)))


@full_float32_matmul()
def _grarep_dense(csr: CsrMatrix, omega: torch.Tensor, max_step: int, k: int,
                  power_iters: int) -> torch.Tensor:
    """Dense GraRep (cleora_tpu/algorithms.py:453-465): kernel K6, then per
    step the log clip of P^step (kernel K7, on a copy while the power is
    still needed) and its randomized SVD."""
    P, _, _ = dense_markov(csr)
    embs = []
    Pk = P
    for step in range(max_step):
        last = step + 1 == max_step
        M_log = log_clip(Pk if last else Pk.clone(), None, None,
                         _GRAREP_FLOOR, _GRAREP_OFFSET)
        embs.append(rsvd_u_sqrt(M_log, omega[step], k, power_iters))
        del M_log
        if not last:
            Pk = torch.matmul(Pk, P)
    return torch.cat(embs, dim=1)


# ------------------- blocked (beyond device memory) device log-factorizations
# The elementwise log forces NetMF/GraRep into an explicit dense matrix, but
# only a ROW BLOCK of it needs to exist at a time.  Each block of M's rows is
# materialized on the fly — the transition-power walk S_t = E_b·P^t runs as
# Y_t = (Pᵀ)^t·E_bᵀ, i.e. T SpMMs at feature width b — then the log-clip
# (kernel K7) and the two randomized-SVD products follow.  The device holds
# O(n·b), not O(n²), so the device path extends past the dense gate; cost per
# full sweep over M is T·nnz·n/b gathered rows + n²·r matmul FLOPs.
def _pt_values(rows, vals, n: int):
    """The entries Pᵀ[j, i] = A[i, j]/deg[i] of the transpose transition
    operator, in A's COO order, plus deg (float32) and vol of A
    (cleora_tpu/algorithms.py:534-540)."""
    deg64 = np.bincount(rows, weights=vals.astype(np.float64), minlength=n)
    vol = float(deg64.sum())
    deg = np.maximum(deg64, 1e-10).astype(np.float32)
    return (vals / deg[rows]).astype(np.float32), deg, vol


def _pt_csr(rows, cols, vals, n: int, device):
    """CSR of the TRANSPOSE transition operator Pᵀ, plus deg and vol of A
    (no relabelling: the CSR keeps original row order)."""
    pt_vals, deg, vol = _pt_values(rows, vals, n)
    return CsrMatrix.transpose_from_coo(rows, cols, pt_vals, n, device), deg, vol


def _auto_block_rows(n: int, r: int, limit=None,
                     device: Optional[torch.device] = None) -> int:
    """Largest block width, a multiple of 128, whose O(n·b) working set
    (three (n, b) f32 buffers + rSVD (n, r) operands) fits half the
    device.  A multiple of 128 is whole bands of ``panel_band``'s 32
    columns, so the blocked GraRep's band-major panels (y, the next y and
    L) pad nothing."""
    if limit is None and device is not None:
        limit = memory.device_memory_limit(device)
    if limit is None:
        b = 4096
    else:
        budget = int(limit * 0.5) - 6 * n * r * 4
        b = budget // (16 * n)
    b = min(b, 4096, n)
    return int(max(128, (b // 128) * 128)) if b >= 128 else int(max(8, b))


def _block_shape(n: int, r: int, block_rows, device) -> int:
    b = int(block_rows) if block_rows else _auto_block_rows(n, r,
                                                            device=device)
    return max(1, min(b, n))


def _one_hot_block(n: int, b: int, start: int, device) -> torch.Tensor:
    """E_bᵀ: (n, b) with y[start + j, j] = 1 for start + j < n (the padded
    tail columns of the last block stay 0): the one-band panel."""
    return one_hot_bands(n, b, b, start, device)[0]


def _pad_rows(v: torch.Tensor, n_pad: int) -> torch.Tensor:
    """``v`` with zero rows appended to its second-to-last axis up to
    ``n_pad``."""
    extra = n_pad - v.shape[-2]
    if extra == 0:
        return v
    return torch.cat([v, v.new_zeros((*v.shape[:-2], extra, v.shape[-1]))],
                     dim=-2)


def _sweep_blocks(block, n: int, b: int, W, V):
    """One sweep over the row blocks of M: ``block(start, W, Vp)`` returns a
    block's (Lᵀ·W, L·Vp[start:start+b]); the sweep returns (M·W, Mᵀ·V) at
    (n, r).  An operand that is None is skipped and its product comes back
    None.  A leading stack axis (GraRep: one slice per step) passes
    through."""
    n_pad = -(-n // b) * b
    Vp = None if V is None else _pad_rows(V, n_pad)
    pieces, G = [], None
    for start in range(0, n_pad, b):
        br, nr = block(start, W, Vp)
        pieces.append(br)
        if nr is not None:
            G = nr if G is None else G.add_(nr)
    Y = None if W is None else torch.cat(pieces, dim=-2)[..., :n, :]
    return Y, G


def _blocked_u_sqrt(block, n: int, b: int, k: int, power_iters: int,
                    omega: torch.Tensor) -> torch.Tensor:
    """Streamed twin of :func:`rsvd_u_sqrt` over :func:`_sweep_blocks`:
    identical math, one sweep per product (2 + 2·power_iters sweeps
    total)."""
    Y, _ = _sweep_blocks(block, n, b, omega, None)
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(Y)
        _, G = _sweep_blocks(block, n, b, None, Q)
        Y, _ = _sweep_blocks(block, n, b, G, None)
    Q, _ = torch.linalg.qr(Y)
    _, C = _sweep_blocks(block, n, b, None, Q)  # (n, r);  Cᵀ = Qᵀ·M
    Ub, s, _ = torch.linalg.svd(C.mT, full_matrices=False)
    su = torch.sqrt(torch.clamp_min(s[..., :k], 0.0))
    return torch.matmul(Q, Ub[..., :k]) * su[..., None, :]


@full_float32_matmul()
def _netmf_blocked_device(graph, feature_dim: int, window_size: int,
                          negative_samples: float, seed: int, oversample: int,
                          power_iters: int, block_rows=None,
                          device=None) -> np.ndarray:
    dev = resolve_device(device)
    rows, cols, vals, n = _coo_f32(graph)
    csr_pt, deg, vol = _pt_csr(rows, cols, vals, n, dev)
    k = min(feature_dim, n)
    r = min(n, k + oversample)
    b = _block_shape(n, r, block_rows, dev)
    window = max(1, window_size)

    rng = np.random.default_rng(seed)
    # the same draws as the dense path, so the sketch Y = M·Ω matches it
    omega = torch.from_numpy(
        rng.standard_normal((n, r)).astype(np.float32)).to(dev)
    deg_dev = torch.from_numpy(deg).to(dev)
    scale = np.float32(vol / (negative_samples * window))
    # s_col[i] = scale/deg[i]; 0 on the padded tail, where acc is 0 as well
    s_col = _pad_rows((float(scale) / deg_dev)[:, None], n + b)[:, 0]

    def block(start: int, W, V):
        """One row block of M_log as its (n, b) transpose L, and the two
        sketch products (Lᵀ·W, L·V[start:start+b])
        (cleora_tpu/algorithms.py:583-605)."""
        y = _one_hot_block(n, b, start, dev)
        acc = torch.zeros_like(y)
        for _ in range(window):
            y = spmm_axpy(csr_pt, y, 1.0, acc=acc, d=1.0)
        L = log_clip(acc, deg_dev, s_col[start:start + b].contiguous(),
                     1.0, 0.0)
        return (None if W is None else torch.matmul(L.T, W),
                None if V is None else torch.matmul(L, V[start:start + b]))

    return _fetch_f64(_blocked_u_sqrt(block, n, b, k, power_iters, omega))


@full_float32_matmul()
def _grarep_blocked_device(graph, feature_dim: int, max_step: int, seed: int,
                           oversample: int, power_iters: int,
                           block_rows=None, device=None) -> np.ndarray:
    dev = resolve_device(device)
    rows, cols, vals, n = _coo_f32(graph)
    csr_pt, _, _ = _pt_csr(rows, cols, vals, n, dev)
    dim_per_step = max(feature_dim // max_step, 1)
    k = min(dim_per_step, n)
    r = min(n, k + oversample)
    b = _block_shape(n, r, block_rows, dev)

    rng = np.random.default_rng(seed)
    omega = torch.from_numpy(
        rng.standard_normal((max_step, n, r)).astype(np.float32)).to(dev)

    g = panel_band(b)

    def block(start: int, W, V):
        """One walk serves ALL steps: at each power P^s the step's log
        block L_s feeds that step's pair of sketch products
        (cleora_tpu/algorithms.py:628-648).  The walk state is the
        band-major panel (bands, n, g) of K1's band form; K7's band form
        writes each power's row-major L out of place, so the walk goes on
        from y itself.  The padded tail columns (of the last block and of
        the last band) hold y == 0 → L == 0, so they need no masking."""
        y = one_hot_bands(n, b, g, start, dev)
        brs, nrs = [], []
        for s in range(max_step):
            y = spmm_bands(csr_pt, y)
            L = log_clip_bands(y, None, None, _GRAREP_FLOOR, _GRAREP_OFFSET,
                               b)
            if W is not None:
                brs.append(torch.matmul(L.T, W[s]))
            if V is not None:
                nrs.append(torch.matmul(L, V[s, start:start + b]))
        return (torch.stack(brs) if brs else None,
                torch.stack(nrs) if nrs else None)

    # W, V: (max_step, n, r) stacks; one walk sweep serves every step
    out = _blocked_u_sqrt(block, n, b, k, power_iters, omega)
    return _fetch_f64(torch.cat(list(out), dim=1))  # (max_step, n, k) → (n, ·)


def _netmf_device(graph, feature_dim: int, window_size: int,
                  negative_samples: float, seed: int, oversample: int,
                  power_iters: int, block_rows=None,
                  device=None) -> np.ndarray:
    dev = resolve_device(device)
    rows, cols, vals, n = _coo_f32(graph)
    if block_rows is not None or not _dense_fits(n, device=dev):
        return _netmf_blocked_device(
            graph, feature_dim, window_size, negative_samples, seed,
            oversample, power_iters, block_rows, dev,
        )
    k = min(feature_dim, n)
    r = min(n, k + oversample)
    rng = np.random.default_rng(seed)
    omega = torch.from_numpy(
        rng.standard_normal((n, r)).astype(np.float32)).to(dev)
    out = _netmf_dense(
        CsrMatrix.from_coo(rows, cols, vals, n, dev), omega,
        float(np.float32(negative_samples)), max(1, window_size), k,
        power_iters,
    )
    return _fetch_f64(out)


def _grarep_device(graph, feature_dim: int, max_step: int, seed: int,
                   oversample: int, power_iters: int,
                   block_rows=None, device=None) -> np.ndarray:
    dev = resolve_device(device)
    rows, cols, vals, n = _coo_f32(graph)
    if block_rows is not None or not _dense_fits(n, device=dev):
        return _grarep_blocked_device(
            graph, feature_dim, max_step, seed, oversample, power_iters,
            block_rows, dev,
        )
    dim_per_step = max(feature_dim // max_step, 1)
    k = min(dim_per_step, n)
    r = min(n, k + oversample)
    rng = np.random.default_rng(seed)
    omega = torch.from_numpy(
        rng.standard_normal((max_step, n, r)).astype(np.float32)).to(dev)
    out = _grarep_dense(
        CsrMatrix.from_coo(rows, cols, vals, n, dev), omega, max_step, k,
        power_iters,
    )
    return _fetch_f64(out)


# ---------------------------------------------------------------- algorithms
def embed_prone(
    graph,
    feature_dim: int = 256,
    mu: float = 0.2,
    theta: float = 0.5,
    seed: int = 0,
    backend: str = "host",
    mesh=None,
    n_devices: Optional[int] = None,
    out: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """ProNE spectral propagation (reference algorithms.py:23-64):
    U = R + Σ_{k=2}^{min(10,n)-1} exp(-θk)·μ · T_k(L_norm)·R, then
    SVD sqrt-singular rescale.

    ``backend="device"`` runs the Chebyshev recurrence on ``device`` in
    float32 (kernel K5); the U_k√S_k epilogue stays a float64 SVD on the
    host, as in the JAX package.  With ``mesh=`` (a
    ``parallel.ShardGroup``) or ``n_devices=`` the recurrence AND the
    U_k√S_k epilogue run sharded over the process group, one shard per
    rank (parallel/algorithms.py; without a group the process is the one
    shard); the output matches the single-device backend up to per-column
    signs.  ``out=`` writes the finalized embedding to a ``.npy`` and
    returns a read-only memmap; with the sharded backend the write streams
    shard by shard."""
    n = graph.num_entities

    if backend == "device" and (mesh is not None or n_devices is not None):
        from .parallel.algorithms import prone_sharded

        res = prone_sharded(graph, feature_dim, mu, theta, seed, mesh=mesh,
                            n_devices=n_devices, out=out, device=device)
        return res if out is not None else _finalize(res, feature_dim)
    if backend == "device":
        U = _fetch_f64(
            _prone_chebyshev_core(graph, feature_dim, mu, theta, seed, device))
    else:
        from scipy.sparse import eye

        N, _ = _sym_normalized(_adjacency(graph))
        L_norm = eye(n) - N
        rng = np.random.default_rng(seed)
        R = rng.standard_normal((n, feature_dim)).astype(np.float64)
        U = R.copy()
        prev = R.copy()
        curr = _dense(L_norm @ R)
        for k in range(2, min(10, n)):
            nxt = _dense(2 * (L_norm @ curr) - prev)
            U += np.exp(-theta * k) * mu * nxt
            prev, curr = curr, nxt

    emb = _finalize(_svd_sqrt(U, feature_dim), feature_dim)
    return _write_npy(emb, out) if out is not None else emb


def embed_randne(
    graph,
    feature_dim: int = 256,
    num_iterations: int = 40,
    weights: Optional[List[float]] = None,
    seed: int = 0,
    backend: str = "host",
    mesh=None,
    n_devices: Optional[int] = None,
    out: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """RandNE iterated Gaussian projection (reference algorithms.py:67-100):
    U = Σ_i w_i · N^i · R with N = D^-1/2 A D^-1/2, w_i = 1/2^i default.

    ``backend="device"`` runs the weighted-power loop on ``device`` in
    float32 (kernel K5); with ``mesh=``/``n_devices=`` it runs sharded over
    the process group (parallel/algorithms.py).  ``out=`` writes the
    finalized embedding to a ``.npy`` and returns a read-only memmap; with
    the sharded backend the write streams shard by shard."""
    n = graph.num_entities
    if weights is None:
        weights = [1.0 / (2**i) for i in range(num_iterations + 1)]
    # the reference reuses the last weight if the list is short
    full = [
        weights[i] if i < len(weights) else weights[-1]
        for i in range(num_iterations + 1)
    ]

    if backend == "device" and (mesh is not None or n_devices is not None):
        from .parallel.algorithms import randne_sharded

        # draws its own R, a float32 slice per shard
        res = randne_sharded(graph, feature_dim, full, seed, mesh=mesh,
                             n_devices=n_devices, out=out, device=device)
        return res if out is not None else _finalize(res, feature_dim)
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, feature_dim))
    if backend == "device":
        U = _device_spmm_weighted_sum(graph, R, full, sym_norm=True,
                                      device=device)
    else:
        A = _adjacency(graph)
        N, _ = _sym_normalized(A)
        U = full[0] * R
        current = R.copy()
        for i in range(num_iterations):
            current = _dense(N @ current)
            U += full[i + 1] * current

    emb = _finalize(U, feature_dim)
    return _write_npy(emb, out) if out is not None else emb


def embed_hope(
    graph,
    feature_dim: int = 256,
    beta: float = 0.1,
    backend: str = "host",
    seed: int = 0,
    oversample: int = 8,
    power_iters: int = 2,
    mesh=None,
    n_devices: Optional[int] = None,
    out: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """HOPE Katz-proximity factorization (reference algorithms.py:103-149):
    M = (I − βA)^-1 − I, truncated SVD at dim/2, concat source ∥ target.

    ``backend="device"`` runs a matrix-free randomized SVD on ``device``:
    the Katz inverse is applied as a Neumann series of SpMMs (kernel K5), so
    the n×n proximity matrix is never materialized — HOPE scales to graphs
    where the host path (and the reference) run out of memory.  Requires
    β·‖A‖_∞ < 1; accuracy is the usual randomized-SVD guarantee, tunable via
    ``oversample``/``power_iters``.  seed only affects the device sketch.
    With ``mesh=``/``n_devices=`` the whole pipeline (the Neumann series,
    CholeskyQR2 subspace iteration, the Gram SVD) runs sharded over the
    process group (parallel/algorithms.py).  ``out=`` writes the finalized
    embedding to a ``.npy`` and returns a read-only memmap; with the
    sharded backend the write streams shard by shard."""
    n = graph.num_entities

    if backend == "device" and (mesh is not None or n_devices is not None):
        from .parallel.algorithms import hope_sharded

        result = hope_sharded(graph, feature_dim, beta, seed, oversample,
                              power_iters, mesh=mesh, n_devices=n_devices,
                              out=out, device=device)
        return result if out is not None else _finalize(result, feature_dim)
    if backend == "device":
        result = _hope_device(
            graph, feature_dim, beta, seed, oversample, power_iters, device
        )
        emb = _finalize(result, feature_dim)
        return _write_npy(emb, out) if out is not None else emb

    A = _adjacency(graph)

    from scipy.sparse import csr_matrix, eye

    S = eye(n) - beta * A
    try:
        from scipy.sparse.linalg import inv as sparse_inv

        S_inv = sparse_inv(S.tocsc())
    except Exception:
        S_inv = csr_matrix(np.linalg.inv(S.toarray()))
    M = S_inv - eye(n)

    k = min(feature_dim // 2, n - 1)
    try:
        from scipy.sparse.linalg import svds

        u, s, vt = svds(M, k=k)
        order = np.argsort(-s)
        u, s, vt = u[:, order], s[order], vt[order, :]
    except Exception:
        u, s, vt = np.linalg.svd(_dense(M), full_matrices=False)
        u, s, vt = u[:, :k], s[:k], vt[:k, :]

    sqrt_s = np.sqrt(np.maximum(s, 0))
    result = np.concatenate([u * sqrt_s, vt.T * sqrt_s], axis=1)
    emb = _finalize(result, feature_dim)
    return _write_npy(emb, out) if out is not None else emb


def embed_netmf(
    graph,
    feature_dim: int = 256,
    window_size: int = 5,
    negative_samples: float = 1.0,
    backend: str = "host",
    seed: int = 0,
    oversample: int = 10,
    power_iters: int = 2,
    block_rows: Optional[int] = None,
    mesh=None,
    n_devices: Optional[int] = None,
    out: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """NetMF log-PMI factorization (reference algorithms.py:152-198):
    M = (vol/b) · D^-1 · mean(P^1..P^w) · D, log-clipped at 1, full SVD.

    ``backend="device"`` runs the whole pipeline on ``device``: the dense
    transition matrix (kernel K6), its powers as full-float32 matmuls, the
    log-clip (kernel K7) and, for the full SVD, a randomized SVD of width
    ``feature_dim + oversample`` (exact when that reaches n).  Past the
    dense gate (6·n²·4 bytes above 90 % of the device's free memory) the
    device backend automatically switches to the BLOCKED path
    (:func:`_netmf_blocked_device`): M_log is materialized one row block at
    a time via transition-power walks (kernel K5) and streamed through the
    randomized SVD, so the device holds O(n·block) — any n that fits the
    embedding itself runs on the device.  ``block_rows`` forces the blocked
    path with that block width (auto-sized when None).  With
    ``mesh=``/``n_devices=`` the blocked path runs sharded over the process
    group: the (n, b) blocks and the sketch panels are each rank's rows
    (parallel/algorithms.py:netmf_sharded).  ``out=`` persists the
    finalized embedding to a ``.npy`` and returns a read-only memmap."""
    if backend == "device" and (mesh is not None or n_devices is not None):
        from .parallel.algorithms import netmf_sharded

        res = netmf_sharded(graph, feature_dim, window_size,
                            negative_samples, seed, oversample, power_iters,
                            block_rows=block_rows, mesh=mesh,
                            n_devices=n_devices, out=out, device=device)
        return res if out is not None else _finalize(res, feature_dim)
    if backend == "device":
        emb = _finalize(
            _netmf_device(graph, feature_dim, window_size, negative_samples,
                          seed, oversample, power_iters, block_rows, device),
            feature_dim,
        )
        return _write_npy(emb, out) if out is not None else emb
    n = graph.num_entities
    A = _adjacency(graph)

    from scipy.sparse import csr_matrix, diags, eye

    degrees = np.asarray(A.sum(axis=1)).ravel()
    vol = degrees.sum()
    degrees = np.maximum(degrees, 1e-10)
    D_inv = diags(1.0 / degrees)
    P = D_inv @ A

    M_sum = csr_matrix((n, n), dtype=np.float64)
    P_power = eye(n, dtype=np.float64)
    for _ in range(window_size):
        P_power = P_power @ P
        M_sum = M_sum + P_power
    M_sum = M_sum / window_size

    M = (vol / negative_samples) * D_inv @ M_sum @ diags(degrees)
    M_log = np.log(np.maximum(_dense(M), 1.0))
    emb = _finalize(_svd_sqrt(M_log, min(feature_dim, n)), feature_dim)
    return _write_npy(emb, out) if out is not None else emb


def embed_grarep(
    graph,
    feature_dim: int = 256,
    max_step: int = 4,
    backend: str = "host",
    seed: int = 0,
    oversample: int = 10,
    power_iters: int = 2,
    block_rows: Optional[int] = None,
    mesh=None,
    n_devices: Optional[int] = None,
    out: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """GraRep per-step log(P^k) SVDs, concat dim/max_step each
    (reference algorithms.py:201-245).

    ``backend="device"`` runs dense P^k powers as full-float32 matmuls
    (after kernel K6), the log clip as kernel K7 and a per-step randomized
    SVD; past the dense gate it switches to the blocked streaming path
    like the device NetMF (one transition-power walk of kernel K1 per sweep
    serves every step's sketch), so any n that fits the embedding runs on
    the device.  ``block_rows`` forces the blocked path.  With
    ``mesh=``/``n_devices=`` the blocked path runs sharded over the process
    group (parallel/algorithms.py:grarep_sharded).  ``out=`` persists the
    finalized embedding to a ``.npy`` and returns a read-only memmap."""
    if backend == "device" and (mesh is not None or n_devices is not None):
        from .parallel.algorithms import grarep_sharded

        res = grarep_sharded(graph, feature_dim, max_step, seed, oversample,
                             power_iters, block_rows=block_rows, mesh=mesh,
                             n_devices=n_devices, out=out, device=device)
        return res if out is not None else _finalize(res, feature_dim)
    if backend == "device":
        emb = _finalize(
            _grarep_device(graph, feature_dim, max_step, seed, oversample,
                           power_iters, block_rows, device),
            feature_dim,
        )
        return _write_npy(emb, out) if out is not None else emb
    n = graph.num_entities
    A = _adjacency(graph)

    from scipy.sparse import diags

    degrees = np.maximum(np.asarray(A.sum(axis=1)).ravel(), 1e-10)
    P = diags(1.0 / degrees) @ A

    dim_per_step = max(feature_dim // max_step, 1)
    embs = []
    P_k = P.copy()
    for step in range(1, max_step + 1):
        M_log = np.log(np.maximum(_dense(P_k), 1e-10)) - np.log(1e-10)
        embs.append(_svd_sqrt(M_log, min(dim_per_step, n)))
        if step < max_step:
            P_k = P_k @ P

    emb = _finalize(np.concatenate(embs, axis=1), feature_dim)
    return _write_npy(emb, out) if out is not None else emb


# ------------------------------------------------------ device walk pipeline
_WALK_BATCH = WALK_BATCH
# the port's walks (Philox, ops/walk.py) are not the JAX package's
# (jax.random), so its checkpoints carry their own engine tag and a port run
# never resumes from counts the JAX package wrote
_WALK_ENGINE = "walk1-philox"
_WALK2_ENGINE = "walk2-philox"
# Second-order walks per device batch.  The JAX package's 65,536
# (cleora_tpu/algorithms.py:1982-1986) is a limit of its TPU worker; here
# the batch is the first-order path's device-counting batch, whose pair keys
# the counting sort already holds beside the finished ranges.
_WALK2_BATCH = _WALK_BATCH // 2


def _cached(graph, key, build):
    """``build()``, kept in the graph's cache under ``key`` (graphs without
    a cache build every time)."""
    cache = getattr(graph, "_device_cache", None)
    value = cache.get(key) if cache is not None else None
    if value is None:
        value = build()
        if cache is not None:
            cache[key] = value
    return value


def _walk_csr(graph, with_vals: bool = False):
    """Self-loop-free CSR on host (reference drops r==c, algorithms.py:248-259),
    cached per graph: ``(indptr[:-1] int32, cols int32, deg int32, n)``
    (cleora_tpu/algorithms.py:1165-1186).  ``with_vals`` additionally
    returns the edge weights, the per-row max and the per-row sum."""
    return _cached(graph, ("walk_csr", with_vals),
                   lambda: _walk_csr_build(graph, with_vals))


def _walk_csr_build(graph, with_vals: bool):
    if not hasattr(graph, "to_sparse_csr"):
        return _walk_csr_build_disk(graph, with_vals)
    rows, cols, vals, n, _ = graph.to_sparse_csr()
    keep = rows != cols
    rows = rows[keep].astype(np.int64)
    cols = cols[keep].astype(np.int32)
    deg = np.bincount(rows, minlength=n).astype(np.int32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    if int(indptr[-1]) >= 2**31:
        # the walk kernel gathers with int32 edge offsets
        raise ValueError(
            f"graph has {int(indptr[-1])} self-loop-free edges; the device "
            "walk engines support < 2**31 — use backend='host' or shard the "
            "walk workload by subgraph"
        )
    ip32 = indptr[:-1].astype(np.int32)
    if not with_vals:
        return ip32, cols, deg, n
    v = vals[keep].astype(np.float32)
    wmax = np.zeros(n, dtype=np.float32)
    np.maximum.at(wmax, rows, v)
    wsum = np.zeros(n, dtype=np.float64)
    np.add.at(wsum, rows, v.astype(np.float64))
    return ip32, cols, deg, n, v, wmax, wsum.astype(np.float32)


def _walk_csr_build_disk(g, with_vals: bool, chunk_rows: int = 1 << 21):
    """The walk CSR straight off a DiskGraph's memmaps
    (cleora_tpu/algorithms.py:1218-1277): two bounded passes over the
    on-disk arrays (count the self-loops, then fill), never the entity-id
    strings or the int64 COO rows that ``to_sparse_matrix()`` would build.
    Bitwise the in-RAM CSR of the same graph.  One host's piece of a
    sharded build is refused: its walks would dead-end at every row it
    lacks."""
    pr = (g.meta.get("row_range") if getattr(g, "meta", None) else None)
    if pr is not None and (int(pr[0]) > 0 or int(pr[1]) < g.num_entities):
        raise ValueError(
            f"This DiskGraph is one host's piece of a sharded build "
            f"(rows {pr}); the walk engines need the whole graph — merge "
            "the pieces first (graph.stream.merge_disk_graph_shards)."
        )
    n = g.num_entities
    src_ip = g.indptr  # (n+1,) int64 memmap

    def chunks():
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            s, e = int(src_ip[lo]), int(src_ip[hi])
            counts = np.diff(np.asarray(src_ip[lo:hi + 1]))
            cols_c = np.asarray(g.indices[s:e])
            rows_c = np.repeat(np.arange(lo, hi, dtype=np.int64), counts)
            yield lo, hi, s, e, counts, cols_c, rows_c

    deg = np.zeros(n, dtype=np.int64)
    for lo, hi, _, _, counts, cols_c, rows_c in chunks():
        loops = np.bincount(rows_c[cols_c == rows_c] - lo, minlength=hi - lo)
        deg[lo:hi] = counts - loops
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    nnz = int(indptr[-1])
    if nnz >= 2**31:
        raise ValueError(
            f"graph has {nnz} self-loop-free edges; the device walk "
            "engines support < 2**31 — use backend='host' or shard the "
            "walk workload by subgraph"
        )
    cols = np.empty(nnz, dtype=np.int32)
    v = np.empty(nnz, dtype=np.float32) if with_vals else None
    for lo, hi, s, e, _, cols_c, rows_c in chunks():
        keep = cols_c != rows_c
        o, d = int(indptr[lo]), int(indptr[hi])
        cols[o:d] = cols_c[keep]
        if with_vals:
            v[o:d] = np.asarray(g.left_vals[s:e])[keep]
    deg32 = deg.astype(np.int32)
    ip32 = indptr[:-1].astype(np.int32)
    if not with_vals:
        return ip32, cols, deg32, n
    rows64 = np.repeat(np.arange(n, dtype=np.int64), deg)
    wmax = np.zeros(n, dtype=np.float32)
    np.maximum.at(wmax, rows64, v)
    wsum = np.zeros(n, dtype=np.float64)
    np.add.at(wsum, rows64, v.astype(np.float64))
    return ip32, cols, deg32, n, v, wmax, wsum.astype(np.float32)


def _walk_mesh(mesh, n_devices, device, sharded: bool = False):
    """The shard group of a walk run (cleora_tpu/algorithms.py:2509-2514):
    ``mesh`` (a ``parallel.ShardGroup``), or the calling process's shard
    for ``n_devices=``, or for sharded tables or factorization asked for
    without either (the process is then the one shard); None for the
    single-card path."""
    if mesh is None and n_devices is None and not sharded:
        return None
    from .parallel.algorithms import _mesh_for

    return _mesh_for(mesh, n_devices, device)


def _walk_table_mode(mode: str, n: int, nnz: int, device,
                     second_order: bool = False, world: int = 1,
                     limit=None) -> str:
    """Resolve the walk-table placement (cleora_tpu/algorithms.py:
    1483-1528): 'auto' keeps the CSR replicated on every rank's card (no
    collective per hop) while it fits 90 % of the card's free memory (the
    second-order tables add the edge weights and the per-row wmax/wsum),
    else shards it by rows over the ``world`` ranks when a slice fits, and
    raises past that.  ``limit`` replaces the card's free memory (the CPU
    has none: 'auto' is replicated there)."""
    if mode not in ("auto", "replicated", "sharded"):
        raise ValueError(
            f"Unknown walk_tables '{mode}'. Use 'auto', 'replicated' or "
            "'sharded'."
        )
    if mode != "auto":
        return mode
    if limit is None:
        limit = memory.device_memory_limit(device)
    if limit is None:
        return "replicated"
    # cols + indptr + deg (+vals/wmax/wsum for the second-order engine) +
    # ~3 batch-sized (B, L) buffers
    per_edge = 8 if second_order else 4
    table = n * 8 + nnz * per_edge + (n * 12 if second_order else 0)
    batch = 3 * (_WALK2_BATCH if second_order else _WALK_BATCH) * 4 * 80
    if table + batch <= int(limit * 0.9):
        return "replicated"
    if world > 1 and table / world + batch <= int(limit * 0.9):
        return "sharded"
    raise ValueError(
        f"walk tables need ~{table / (1 << 30):.1f} GiB "
        f"({'replicated' if world <= 1 else 'even sharded over the mesh'}"
        f" exceeds the ~{limit / (1 << 30):.1f} GiB device budget) — "
        "use more devices (mesh=), or backend='host' for host-RAM walks"
    )


def _device_walks(graph, num_walks: int, walk_length: int, seed: int,
                  batch: int = _WALK_BATCH, resident: bool = False,
                  walk_tables: str = "auto", device=None, mesh=None):
    """Yield (B, walk_length) int32 host walk batches (sentinel == n), or
    ``(walks, pad)`` left on the device with ``resident=True``
    (cleora_tpu/algorithms.py:1318-1373): one walk from each node of
    degree > 0 per round, ``num_walks`` rounds, by kernel K8.  Under a
    shard group (``mesh``) every rank yields the same batches, bitwise the
    single-card ones: replicated tables walk a block of lanes per rank,
    sharded tables route each hop to the owner of the lane's row (kernel
    K17)."""
    mesh = _walk_mesh(mesh, None, device, walk_tables == "sharded")
    dev = mesh.device if mesh is not None else resolve_device(device)
    indptr, cols, deg, n = _walk_csr(graph)
    world = mesh.world_size if mesh is not None else 1
    mode = _walk_table_mode(walk_tables, n, int(cols.shape[0]), dev,
                            world=world)
    starts = np.nonzero(deg > 0)[0].astype(np.int32)
    if starts.shape[0] == 0:
        return
    if mode == "sharded":
        tables = _cached(
            graph, ("walk_tables_sharded", mesh.rank, world, dev),
            lambda: ShardedWalkTables(indptr, cols, deg, n, mesh.rank, world,
                                      dev))
    else:
        tables = _cached(graph, ("walk_tables", dev),
                         lambda: WalkTables(indptr, cols, deg, n, dev))
    yield from device_walks(tables, starts, num_walks, walk_length, seed,
                            batch=batch, resident=resident, group=mesh)


def _device_walks2(graph, num_walks: int, walk_length: int, p: float,
                   q: float, seed: int, batch: int = _WALK2_BATCH,
                   tries: Optional[int] = None, resident: bool = False,
                   walk_tables: str = "auto", device=None, mesh=None):
    """Yield (B, walk_length) int32 host batches of p/q-biased walks
    (sentinel == n), or ``(walks, pad)`` left on the device with
    ``resident=True`` (cleora_tpu/algorithms.py:1989-2063): one walk from
    each node of degree > 0 per round, ``num_walks`` rounds, by kernel K12
    (K18 over sharded tables, as :func:`_device_walks`).  ``tries``
    defaults to ``min(1024, max(64, ⌈8q⌉))``; the walks depend on neither
    ``batch`` nor the table placement."""
    mesh = _walk_mesh(mesh, None, device, walk_tables == "sharded")
    dev = mesh.device if mesh is not None else resolve_device(device)
    indptr, cols, deg, n, vals, wmax, wsum = _walk_csr(graph, with_vals=True)
    world = mesh.world_size if mesh is not None else 1
    mode = _walk_table_mode(walk_tables, n, int(cols.shape[0]), dev,
                            second_order=True, world=world)
    if tries is None:
        tries = walk2_tries(q)
    starts = np.nonzero(deg > 0)[0].astype(np.int32)
    if starts.shape[0] == 0:
        return
    if mode == "sharded":
        tables = _cached(
            graph, ("walk_tables2_sharded", mesh.rank, world, dev),
            lambda: ShardedWalkTables(indptr, cols, deg, n, mesh.rank, world,
                                      dev, vals, wmax, wsum))
    else:
        tables = _cached(graph, ("walk_tables2", dev),
                         lambda: WalkTables2(indptr, cols, deg, n, vals, wmax,
                                             wsum, dev))
    yield from device_walks2(tables, starts, num_walks, walk_length, p, q,
                             tries, seed, batch, resident=resident,
                             group=mesh)


def _unique_counts_u64(keys: np.ndarray):
    """Unique keys + occurrence counts via the native parallel radix sort
    (cleora_tpu/algorithms.py:2066-2080)."""
    if keys.size == 0:
        return keys, np.empty(0, dtype=np.int64)
    keys = sort_u64(keys)
    boundaries = np.concatenate([[True], keys[1:] != keys[:-1]])
    starts = np.nonzero(boundaries)[0]
    counts = np.diff(np.append(starts, keys.size))
    return keys[starts].copy(), counts


def _merge_counts(keys_parts, counts_parts):
    """Sort-reduce (keys, counts) fragments into unique keys + summed
    counts (fragments are each sorted — numpy's stable mergesort exploits
    the runs)."""
    keys = np.concatenate(keys_parts)
    counts = np.concatenate(counts_parts)
    order = np.argsort(keys, kind="stable")
    keys, counts = keys[order], counts[order]
    boundaries = np.concatenate([[True], keys[1:] != keys[:-1]])
    starts = np.nonzero(boundaries)[0]
    return keys[starts], np.add.reduceat(counts, starts)


def _walk_pair_counts(walk_batches, n: int, window: int):
    """Sparse symmetric windowed co-occurrence over host walk batches, as
    (keys = center·n + context, counts), counted on the host in int64
    (cleora_tpu/algorithms.py:2096-2135)."""
    acc_keys = [np.empty(0, dtype=np.uint64)]
    acc_counts = [np.empty(0, dtype=np.int64)]
    for walks in walk_batches:
        parts = []
        for off in range(1, window + 1):
            if off >= walks.shape[1]:
                break
            a = walks[:, :-off].ravel()
            b = walks[:, off:].ravel()
            m = (a < n) & (b < n)
            a = a[m].astype(np.uint64)
            b = b[m].astype(np.uint64)
            parts.append(a * np.uint64(n) + b)
            parts.append(b * np.uint64(n) + a)
        if not parts:
            continue
        batch_keys = np.concatenate(parts)
        parts.clear()
        u, c = _unique_counts_u64(batch_keys)
        del batch_keys
        acc_keys.append(u)
        acc_counts.append(c)
        if len(acc_keys) > 16:  # bound the fragment list
            k, c = _merge_counts(acc_keys, acc_counts)
            acc_keys, acc_counts = [k], [c]
    keys, counts = _merge_counts(acc_keys, acc_counts)
    return keys.astype(np.int64), counts


def _column_signs(u: torch.Tensor) -> torch.Tensor:
    """±1 per column: the sign of the column's largest-|u| entry, the first
    such row on ties (``argmax`` picks the first maximum on the CPU and the
    card, as numpy does); 0 counts as +1."""
    pick = torch.argmax(torch.abs(u), dim=0)
    sign = torch.sign(u[pick, torch.arange(u.shape[1], device=u.device)])
    return torch.where(sign == 0, torch.ones_like(sign), sign)


# rows of the (n, k) factor fetched and finalized at a time by out=
_FINALIZE_ROWS = 1 << 18


def _finalize_factor(u_su: torch.Tensor, feature_dim: int, out):
    """The rsvd exit (cleora_tpu/algorithms.py:2229-2280): column signs
    canonicalized on the device, then ``_finalize`` on the host in float64,
    either whole or streamed into ``out`` (.npy) in row chunks, so the host
    never holds more than one chunk.  Returns the array or the read-only
    memmap."""
    sign = _fetch_f64(_column_signs(u_su))
    if out is None:
        return _finalize(_fetch_f64(u_su) * sign, feature_dim)
    n = int(u_su.shape[0])
    tmp = out + ".tmp"
    mm = np.lib.format.open_memmap(
        tmp, mode="w+", dtype=np.float32, shape=(n, feature_dim))
    for lo in range(0, n, _FINALIZE_ROWS):
        block = _fetch_f64(u_su[lo:lo + _FINALIZE_ROWS]) * sign
        mm[lo:lo + block.shape[0]] = _finalize(block, feature_dim)
    mm.flush()
    del mm
    os.replace(tmp, out)
    return np.load(out, mmap_mode="r")


def _rsvd_flat(pieces: List[CsrMatrix], n: int, k: int, omega: torch.Tensor,
               power_iters: int, feature_dim: int, out=None):
    """The unfused randomized SVD of the PPMI matrix given as row-disjoint
    CSR pieces (cleora_tpu/algorithms.py:2190-2226), then the sign rule and
    ``_finalize``."""
    u_su = rsvd_sparse(pieces, k, omega, power_iters)
    del omega, pieces
    return _finalize_factor(u_su, feature_dim, out)


def _pipeline_fit(n: int, r: int, nnz: int, device, hint: str) -> None:
    """The PPMI factorization's device-memory check, with the walk
    pipeline's hint appended to the message."""
    try:
        memory.check_device_fit(n, max(1, (3 * r) // 2), nnz, device=device)
    except ValueError as e:
        raise ValueError(
            f"{e} For the walk pipeline specifically: {hint}") from None


def _counts_to_embeddings(keys, counts, n: int, feature_dim: int,
                          factorization: str = "host", seed: int = 0,
                          oversample: int = 16, power_iters: int = 4,
                          device=None):
    """Sparse positive-PMI factorization of host counts
    (cleora_tpu/algorithms.py:2310-2413): the PMI in float64 on the host,
    then ARPACK ``svds`` (``factorization="host"``) or the randomized SVD
    on the device over the float32 PPMI matrix as one CSR in original row
    order (kernel K1) and an omega drawn from ``default_rng(seed)``, as
    the JAX package draws it."""
    if keys.shape[0] == 0:
        return _finalize(np.zeros((n, 1), dtype=np.float64), feature_dim)
    rows = keys // n
    cols = keys % n
    counts = counts.astype(np.float64)
    total = counts.sum()
    row_sums = np.zeros(n)
    col_sums = np.zeros(n)
    np.add.at(row_sums, rows, counts)
    np.add.at(col_sums, cols, counts)
    rs = np.maximum(row_sums, 1e-10)
    cs = np.maximum(col_sums, 1e-10)
    pmi = np.log(
        np.maximum(counts * total / (rs[rows] * cs[cols]), 1e-15)
    )
    keep = pmi > 0
    k = min(feature_dim, n - 1)
    if k < 1 or not bool(keep.any()):
        return _finalize(np.zeros((n, 1), dtype=np.float64), feature_dim)

    if factorization == "device":
        dev = resolve_device(device)
        krows = rows[keep].astype(np.int64)
        kcols = cols[keep].astype(np.int64)
        kvals = pmi[keep].astype(np.float32)
        order = np.argsort(krows, kind="stable")
        r = min(n, k + oversample)
        _pipeline_fit(n, r, krows.shape[0], dev,
                      "fewer walks, a smaller window, or "
                      "factorization='host' (ARPACK) all shrink or avoid the "
                      "device PPMI factorization.")
        csr = CsrMatrix.from_coo(krows[order], kcols[order], kvals[order], n,
                                 dev)
        rng = np.random.default_rng(seed)
        omega = torch.from_numpy(
            rng.standard_normal((n, r)).astype(np.float32)).to(dev)
        return _rsvd_flat([csr], n, k, omega, power_iters, feature_dim)
    if factorization != "host":
        raise ValueError(
            f"Unknown factorization '{factorization}'. Use 'host' or "
            "'device'."
        )

    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import svds

    M = coo_matrix(
        (pmi[keep], (rows[keep], cols[keep])), shape=(n, n)
    ).tocsr()
    if M.nnz == 0:
        return _finalize(np.zeros((n, 1), dtype=np.float64), feature_dim)
    u, s, _ = svds(M, k=k)
    order = np.argsort(-s)
    u = u[:, order]
    # canonical column signs (ARPACK's are run-dependent): largest-|u| entry
    # positive per column, ties broken by the first such row
    pick = np.argmax(np.abs(u), axis=0)
    sign = np.sign(u[pick, np.arange(u.shape[1])])
    sign[sign == 0] = 1.0
    emb = (u * sign) * np.sqrt(np.maximum(s[order], 0))
    return _finalize(emb, feature_dim)


def _validate_cooccurrence(cooccurrence: str, backend: str,
                           factorization) -> str:
    """Validate the walk-pipeline mode combination; resolve the
    factorization default (None → 'host'; 'device' under device counting)
    (cleora_tpu/algorithms.py:2416-2449)."""
    if cooccurrence not in ("host", "device"):
        raise ValueError(
            f"Unknown cooccurrence '{cooccurrence}'. Use 'host' or 'device'."
        )
    if factorization not in (None, "host", "device", "sharded"):
        raise ValueError(
            f"Unknown factorization '{factorization}'. Use 'host', "
            "'device' or 'sharded'."
        )
    if cooccurrence == "device":
        if backend != "device":
            raise ValueError(
                "cooccurrence='device' requires backend='device'")
        if factorization == "host":
            raise ValueError(
                "cooccurrence='device' runs the PPMI factorization on "
                "device; omit factorization or pass 'device'/'sharded'"
            )
        return factorization or "device"
    if factorization == "sharded":
        raise ValueError(
            "factorization='sharded' requires cooccurrence='device' (it "
            "factorizes the device-resident count ranges in place)"
        )
    return factorization or "host"


def _walk_fingerprint(graph, with_vals: bool, params: dict) -> str:
    """Content fingerprint of a walk-pipeline run: every byte of the walk
    CSR plus the walk and counting parameters
    (cleora_tpu/algorithms.py:2452-2471)."""
    import hashlib
    import json

    h = hashlib.blake2b(digest_size=16)
    arrs = _walk_csr(graph, with_vals=with_vals)
    indptr, cols = arrs[0], arrs[1]
    h.update(np.ascontiguousarray(indptr).data)
    h.update(np.ascontiguousarray(cols).data)
    if with_vals:
        h.update(np.ascontiguousarray(arrs[4]).data)
    h.update(json.dumps(params, sort_keys=True, default=str).encode())
    return h.hexdigest()


def _validate_lifecycle(graph, backend: str, cooccurrence: str,
                        checkpoint_dir) -> None:
    """Lifecycle-argument validation for the walk pipeline
    (cleora_tpu/algorithms.py:2490-2506)."""
    if checkpoint_dir is not None and cooccurrence != "device":
        raise ValueError(
            "checkpoint_dir requires cooccurrence='device' (the counting "
            "checkpoint is per device counting pass)"
        )
    if backend != "device" and not hasattr(graph, "to_sparse_csr"):
        raise ValueError(
            "DiskGraph input requires backend='device' (or materialize "
            "with graph.to_sparse_matrix() for the host walker)"
        )


# a counting pass's sort-merge working set stays well under device memory
# when the pass sees at most this many (pre-dedup) pairs; the JAX package's
# budget, so that both packages partition a corpus alike
_COOC_PASS_PAIRS = 200_000_000


def _cooc_passes(graph, num_walks: int, walk_length: int,
                 window_size: int) -> int:
    """Hash partitions for :func:`ops.cooccur.device_pair_counts`, from the
    worst-case (all-unique) pair count of the walk corpus
    (cleora_tpu/algorithms.py:2523-2534)."""
    deg = _walk_csr(graph)[2]
    starts = int((deg > 0).sum()) * num_walks
    w = min(window_size, walk_length - 1)
    per_walk = 2 * (w * walk_length - w * (w + 1) // 2)
    return max(1, -(-starts * per_walk // _COOC_PASS_PAIRS))


def _walks_ppmi_device(graph, feature_dim, window_size, seed, batches_fn,
                       passes=1, oversample=16, power_iters=4,
                       checkpoint_dir=None, checkpoint_every=1, out=None,
                       fp_params=None, factorization="device", device=None,
                       mesh=None):
    """Walks → co-occurrence → PPMI → randomized SVD, all on the device
    (cleora_tpu/algorithms.py:2537-2621).  ``batches_fn()`` returns a fresh
    iterable of resident ``(walks, pad)`` batches.

    Under a shard group (``mesh``) every rank holds every walk batch and
    counts the hash partitions ``s`` with ``s % P == rank``, which stay on
    it (:func:`ops.cooccur.device_pair_counts`); :func:`_factorize_ranges`
    places the factorization.

    ``checkpoint_dir`` makes the counting durable per hash partition
    (:class:`ops.cooccur.CountCheckpoint`, keyed by a full-content
    fingerprint of the walk CSR and the parameters, not by the rank count,
    so a run resumes under another one); a killed run resumes from the
    counted partitions and a finished run returns its memmap.  ``out``
    streams the final embedding into one ``.npy`` (defaults to
    ``<checkpoint_dir>/embedding.npy`` when checkpointing)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    checkpoint = None
    fact_params = dict(feature_dim=feature_dim, oversample=oversample,
                       power_iters=power_iters,
                       factorization=factorization)
    if checkpoint_dir is not None:
        fp = _walk_fingerprint(
            graph,
            bool(fp_params and fp_params.get("engine") == _WALK2_ENGINE),
            dict(fp_params or {}, window=window_size, passes=passes,
                 n=graph.num_entities, seed=seed),
        )
        checkpoint = CountCheckpoint(checkpoint_dir, fp,
                                     every=checkpoint_every)
        if out is None:
            out = os.path.join(checkpoint_dir, "embedding.npy")
        done = checkpoint.done_result(feature_dim, fact_params)
        if done is not None:
            return done

    n = graph.num_entities
    ranges, m_total = device_pair_counts(batches_fn, n, window_size,
                                         passes=passes,
                                         checkpoint=checkpoint, device=dev,
                                         group=mesh)
    emb = _factorize_ranges(ranges, m_total, n, feature_dim, seed,
                            oversample=oversample, power_iters=power_iters,
                            out=out, factorization=factorization, device=dev,
                            mesh=mesh)
    if checkpoint is not None:
        if mesh is None or mesh.rank == 0:
            checkpoint.mark_done(out, emb.shape, fact_params)
        if mesh is not None:
            mesh.barrier()
    return emb


def _factorize_ranges(ranges, m_total, n, feature_dim, seed,
                      oversample=16, power_iters=4, out=None,
                      factorization="device", device=None, mesh=None):
    """Where counted ranges are factorized (cleora_tpu/algorithms.py:
    2624-2665).  On one card: there.  Under a shard group,
    ``factorization='sharded'`` keeps every partition on the rank that
    counted it and runs the sharded rsvd (parallel/cooccur.py);
    ``'device'`` homes every partition on every rank (an all-gather of the
    variable-length ranges) and factorizes them on each rank's card, unless
    they would not fit one card, in which case the sharded path engages
    (the ranks decide together)."""
    if mesh is None:
        return _device_counts_to_embeddings(ranges, m_total, n, feature_dim,
                                            seed, oversample=oversample,
                                            power_iters=power_iters, out=out,
                                            device=device)
    from .parallel.cooccur import home_ranges, sharded_counts_to_embeddings

    def total(value: int) -> int:
        return int(mesh.all_reduce_(torch.tensor(
            [value], dtype=torch.int64, device=mesh.device))[0])

    use_sharded = factorization == "sharded"
    if not use_sharded and mesh.world_size > 1:
        r = min(n, min(feature_dim, n - 1) + oversample)
        slots = total(sum(int(c.shape[0]) for c, _, _, _ in ranges))
        try:
            memory.check_device_fit(n, max(1, (3 * r) // 2), slots,
                                    device=mesh.device)
            refused = 0
        except ValueError:
            refused = 1
        use_sharded = total(refused) > 0
    if use_sharded:
        return sharded_counts_to_embeddings(
            ranges, m_total, n, feature_dim, seed, oversample=oversample,
            power_iters=power_iters, out=out, group=mesh)
    ranges = home_ranges(ranges, mesh)
    emb = _device_counts_to_embeddings(
        ranges, m_total, n, feature_dim, seed, oversample=oversample,
        power_iters=power_iters, out=out if mesh.rank == 0 else None,
        device=mesh.device)
    return _shared_result(emb, out, mesh)


def _shared_result(emb, out, mesh):
    """Under a group every rank computed ``emb``; rank 0 wrote ``out``
    (when given) and the others return its memmap once it is there."""
    if out is None or mesh is None:
        return emb
    mesh.barrier()
    return emb if mesh.rank == 0 else np.load(out, mmap_mode="r")


def _device_counts_to_embeddings(ranges, m_total, n, feature_dim, seed,
                                 oversample=16, power_iters=4, out=None,
                                 device=None):
    """PPMI + randomized SVD over device-resident count ranges
    (cleora_tpu/algorithms.py:2668-2737).  Each range becomes one CSR of
    the PPMI matrix in original row order (kernel K11), and each product of
    the rsvd adds every range into a zeroed product by K5 with ``acc``,
    over the range's own rows: the ranges are row-disjoint, so the sum is
    exact.  The sketch omega is
    drawn on the host from ``default_rng(seed ^ 0x5EED)`` in float32, so the
    card and ``device="cpu"`` factor the same sketch.  Consumes ``ranges``.
    ``out`` streams the result into a ``.npy``."""
    dev = resolve_device(device)
    k = min(feature_dim, n - 1)
    if m_total == 0 or k < 1:
        empty = _finalize(np.zeros((n, 1), dtype=np.float64), feature_dim)
        return _write_npy(empty, out) if out is not None else empty
    r = min(n, k + oversample)
    slots = sum(int(c.shape[0]) for c, _, _, _ in ranges)
    _pipeline_fit(n, r, slots, dev,
                  "fewer walks, a smaller window, or cooccurrence='host' "
                  "with factorization='host' all shrink the device "
                  "footprint.")
    pieces = ppmi_csrs(ranges, n)
    rng = np.random.default_rng(seed ^ 0x5EED)
    omega = torch.from_numpy(
        rng.standard_normal((n, r)).astype(np.float32)).to(dev)
    return _rsvd_flat(pieces, n, k, omega, power_iters, feature_dim, out=out)


def _host_counted(graph, batches, feature_dim, window_size, seed,
                  factorization, out, dev, mesh):
    """Host counting of the walk batches, then the factorization of
    :func:`_counts_to_embeddings` (every rank of a group holds the same
    batches and computes the same result; rank 0 writes ``out``)."""
    keys, counts = _walk_pair_counts(batches, graph.num_entities, window_size)
    emb = _counts_to_embeddings(keys, counts, graph.num_entities,
                                feature_dim, factorization=factorization,
                                seed=seed, device=dev)
    if out is not None and (mesh is None or mesh.rank == 0):
        emb = _write_npy(emb, out)
    return _shared_result(emb, out, mesh)


def _deepwalk_device(graph, feature_dim, num_walks, walk_length, window_size,
                     seed, factorization="host", mesh=None, n_devices=None,
                     cooccurrence="host", checkpoint_dir=None,
                     checkpoint_every=1, out=None, walk_tables="auto",
                     device=None):
    mesh = _walk_mesh(mesh, n_devices, device,
                      sharded="sharded" in (walk_tables, factorization))
    dev = mesh.device if mesh is not None else resolve_device(device)
    if cooccurrence == "device":
        # half-size batches: the counting sort shares the card with the
        # finished ranges
        return _walks_ppmi_device(
            graph, feature_dim, window_size, seed,
            lambda: _device_walks(graph, num_walks, walk_length, seed,
                                  batch=_WALK_BATCH // 2, resident=True,
                                  walk_tables=walk_tables, device=dev,
                                  mesh=mesh),
            passes=_cooc_passes(graph, num_walks, walk_length, window_size),
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, out=out,
            fp_params=dict(engine=_WALK_ENGINE, num_walks=num_walks,
                           walk_length=walk_length),
            factorization=factorization, device=dev, mesh=mesh,
        )
    batches = _device_walks(graph, num_walks, walk_length, seed,
                            walk_tables=walk_tables, device=dev, mesh=mesh)
    return _host_counted(graph, batches, feature_dim, window_size, seed,
                         factorization, out, dev, mesh)


def _node2vec_device(graph, feature_dim, num_walks, walk_length, window_size,
                     p, q, seed, factorization="host", mesh=None,
                     n_devices=None, cooccurrence="host", checkpoint_dir=None,
                     checkpoint_every=1, out=None, walk_tables="auto",
                     device=None):
    mesh = _walk_mesh(mesh, n_devices, device,
                      sharded="sharded" in (walk_tables, factorization))
    dev = mesh.device if mesh is not None else resolve_device(device)
    if cooccurrence == "device":
        return _walks_ppmi_device(
            graph, feature_dim, window_size, seed,
            lambda: _device_walks2(graph, num_walks, walk_length, p, q,
                                   seed, resident=True,
                                   walk_tables=walk_tables, device=dev,
                                   mesh=mesh),
            passes=_cooc_passes(graph, num_walks, walk_length, window_size),
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, out=out,
            fp_params=dict(engine=_WALK2_ENGINE, num_walks=num_walks,
                           walk_length=walk_length, p=p, q=q),
            factorization=factorization, device=dev, mesh=mesh,
        )
    batches = _device_walks2(graph, num_walks, walk_length, p, q, seed,
                             walk_tables=walk_tables, device=dev, mesh=mesh)
    return _host_counted(graph, batches, feature_dim, window_size, seed,
                         factorization, out, dev, mesh)


# -------------------------------------------------------------- random walks
def _build_adj_list(graph):
    """Out-neighbor lists + weights, self-loops dropped
    (reference algorithms.py:248-259)."""
    rows, cols, vals, n, _ = graph.to_sparse_csr()
    adj = [[] for _ in range(n)]
    weights = [[] for _ in range(n)]
    for r, c, v in zip(rows, cols, vals):
        if r != c:
            adj[r].append(int(c))
            weights[r].append(float(v))
    return adj, weights, n


def _random_walks(adj, weights, n, num_walks, walk_length, p, q, seed):
    """p/q-biased second-order walks; identical RNG stream to the reference
    (algorithms.py:262-312): uniform first step, alpha-reweighted after."""
    rng = np.random.default_rng(seed)
    walks = []
    uniform = p == 1.0 and q == 1.0
    for _ in range(num_walks):
        for start in range(n):
            if not adj[start]:
                continue
            walk = [start]
            prev, curr = -1, start
            for _ in range(walk_length - 1):
                neighbors = adj[curr]
                if not neighbors:
                    break
                if prev == -1 or uniform:
                    nxt = neighbors[rng.integers(len(neighbors))]
                else:
                    w = np.array(weights[curr], dtype=np.float64)
                    alpha = np.ones(len(neighbors), dtype=np.float64)
                    prev_nb = set(adj[prev]) if adj[prev] else set()
                    for j, nb in enumerate(neighbors):
                        if nb == prev:
                            alpha[j] = 1.0 / p
                        elif nb not in prev_nb:
                            alpha[j] = 1.0 / q
                    probs = w * alpha
                    total = probs.sum()
                    if total < 1e-15:
                        break
                    nxt = neighbors[rng.choice(len(neighbors), p=probs / total)]
                walk.append(nxt)
                prev, curr = curr, nxt
            walks.append(walk)
    return walks


def _walks_to_embeddings(walks, n, feature_dim, window_size):
    """Windowed co-occurrence → positive PMI → SVD
    (reference algorithms.py:315-349)."""
    cooccur = np.zeros((n, n), dtype=np.float64)
    for walk in walks:
        arr = np.asarray(walk)
        L = len(arr)
        for offset in range(1, min(window_size, L - 1) + 1):
            np.add.at(cooccur, (arr[:-offset], arr[offset:]), 1.0)
            np.add.at(cooccur, (arr[offset:], arr[:-offset]), 1.0)

    row_sums = np.maximum(cooccur.sum(axis=1, keepdims=True), 1e-10)
    col_sums = np.maximum(cooccur.sum(axis=0, keepdims=True), 1e-10)
    total = cooccur.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.log(np.maximum(cooccur * total / (row_sums * col_sums), 1e-15))
    pmi = np.maximum(pmi, 0.0)
    return _finalize(_svd_sqrt(pmi, min(feature_dim, pmi.shape[1])), feature_dim)


def embed_deepwalk(
    graph,
    feature_dim: int = 256,
    num_walks: int = 10,
    walk_length: int = 80,
    window_size: int = 5,
    seed: int = 0,
    backend: str = "host",
    factorization: Optional[str] = None,
    mesh=None,
    n_devices: Optional[int] = None,
    cooccurrence: str = "host",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    out: Optional[str] = None,
    walk_tables: str = "auto",
    device=None,
) -> np.ndarray:
    """DeepWalk = uniform walks + PMI + SVD (reference algorithms.py:352-361).

    ``backend="host"`` (the default, as in the JAX signature) is the
    reference's Python walker and dense float64 PMI/SVD, copied word for
    word; it touches no device.  ``backend="device"`` generates the walks on
    ``device`` (kernel K8, one thread per walk, Philox uniforms) and
    factorizes a SPARSE positive-PMI matrix: with ``cooccurrence="host"``
    the pairs are counted on the host (native radix sort) and
    ``factorization`` picks ARPACK on the host (default) or the randomized
    SVD on the device; ``cooccurrence="device"`` keeps everything on the
    device — pair keys (K9), ``torch.sort``, run-length counts (K10), the
    PPMI (K11) and the randomized SVD (K1/K5 products, torch QR/SVD) —
    with integer-exact counts.  Same semantics as the JAX package, another
    walk stream (Philox, not jax.random).

    ``checkpoint_dir=`` (device counting) makes the counting durable per
    hash partition and resumes a killed run; ``out="path.npy"`` streams the
    final embedding to disk and returns a read-only memmap.
    With ``mesh=`` (a ``parallel.ShardGroup``) or ``n_devices=`` the
    pipeline runs over the shard group, one rank per card, and every rank
    returns the same result: ``walk_tables`` 'replicated' keeps the walk
    CSR on every card (each rank walks a block of lanes), 'sharded' cuts
    it by rows over the ranks (each hop is computed by the owner of the
    lane's row, kernel K17, or K18 for Node2Vec's p/q walk), 'auto' picks
    the first that fits; the walks are bitwise the one-card walks either
    way.  Device counting leaves hash partition ``s`` on rank ``s % P``;
    ``factorization='sharded'`` factorizes the partitions where they lie
    (parallel/cooccur.py), 'device' gathers them on every rank unless they
    would not fit one card.  ``walk_tables='sharded'`` or
    ``factorization='sharded'`` without a group run on one shard.  A
    DiskGraph is read off its memmaps.

    Rows of nodes in components too small to carry a singular direction
    (their factorization rows are rounding noise, norm about 1e-10) are
    that noise scaled to unit length, on every backend, as in
    ``cleora_tpu``; the port keeps that contract rather than zeroing them,
    so two backends may disagree on exactly those rows."""
    factorization = _validate_cooccurrence(cooccurrence, backend,
                                           factorization)
    _validate_lifecycle(graph, backend, cooccurrence, checkpoint_dir)
    if backend == "device":
        return _deepwalk_device(
            graph, feature_dim, num_walks, walk_length, window_size, seed,
            factorization=factorization, mesh=mesh, n_devices=n_devices,
            cooccurrence=cooccurrence, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, out=out,
            walk_tables=walk_tables, device=device,
        )
    if factorization == "device":
        raise ValueError("factorization='device' requires backend='device'")
    adj, weights, n = _build_adj_list(graph)
    walks = _random_walks(adj, weights, n, num_walks, walk_length, 1.0, 1.0, seed)
    emb = _walks_to_embeddings(walks, n, feature_dim, window_size)
    return _write_npy(emb, out) if out is not None else emb


def embed_node2vec(
    graph,
    feature_dim: int = 256,
    num_walks: int = 10,
    walk_length: int = 80,
    window_size: int = 5,
    p: float = 1.0,
    q: float = 1.0,
    seed: int = 0,
    backend: str = "host",
    factorization: Optional[str] = None,
    mesh=None,
    n_devices: Optional[int] = None,
    cooccurrence: str = "host",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    out: Optional[str] = None,
    walk_tables: str = "auto",
    device=None,
) -> np.ndarray:
    """Node2Vec = p/q-biased walks + PMI + SVD (reference algorithms.py:364-369).

    ``backend="host"`` is the reference's walker for any p, q.
    ``backend="device"`` with ``p == q == 1`` (the reference default) is
    exactly :func:`embed_deepwalk`'s device pipeline; any other p, q walks
    with kernel K12 (one thread per walk, uniform first hop, then the p/q
    bias by composition and rejection with Philox uniforms: the walks are
    bitwise the same on the card and the CPU, and another stream than the
    JAX package's) and then counts and factorizes as DeepWalk does, in
    every ``cooccurrence``/``factorization``/``walk_tables`` mode and over
    a shard group (over sharded tables the hops are kernel K18's stages,
    bitwise K12's walks).  After ``min(1024,
    max(64, ⌈8q⌉))`` rejected proposals a hop takes the last uniform
    proposal, as in the JAX package.  Host-path semantics otherwise,
    dead-row stops included; checkpoints carry the edge weights in their
    fingerprint.  As for :func:`embed_deepwalk`, rows of nodes in small
    components are rounding noise scaled to unit length, as in
    ``cleora_tpu``, and the port keeps that contract."""
    if p <= 0.0 or q <= 0.0:
        raise ValueError("p and q must be positive")
    factorization = _validate_cooccurrence(cooccurrence, backend,
                                           factorization)
    _validate_lifecycle(graph, backend, cooccurrence, checkpoint_dir)
    if backend == "device":
        if p == 1.0 and q == 1.0:
            return _deepwalk_device(
                graph, feature_dim, num_walks, walk_length, window_size,
                seed, factorization=factorization, mesh=mesh,
                n_devices=n_devices, cooccurrence=cooccurrence,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, out=out,
                walk_tables=walk_tables, device=device,
            )
        return _node2vec_device(
            graph, feature_dim, num_walks, walk_length, window_size, p, q,
            seed, factorization=factorization, mesh=mesh,
            n_devices=n_devices, cooccurrence=cooccurrence,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            out=out, walk_tables=walk_tables, device=device,
        )
    if factorization == "device":
        raise ValueError("factorization='device' requires backend='device'")
    adj, weights, n = _build_adj_list(graph)
    walks = _random_walks(adj, weights, n, num_walks, walk_length, p, q, seed)
    emb = _walks_to_embeddings(walks, n, feature_dim, window_size)
    return _write_npy(emb, out) if out is not None else emb


def list_algorithms() -> List[Dict]:
    """Registry (reference algorithms.py:372-389)."""
    return [
        {"name": "prone", "function": "embed_prone",
         "description": "ProNE: Spectral propagation with Chebyshev polynomials. "
                        "Fast and high quality."},
        {"name": "randne", "function": "embed_randne",
         "description": "RandNE: Random projection embedding. Extremely fast, "
                        "good for very large graphs."},
        {"name": "hope", "function": "embed_hope",
         "description": "HOPE: High-Order Proximity Embedding. Asymmetric, good "
                        "for directed graphs."},
        {"name": "netmf", "function": "embed_netmf",
         "description": "NetMF: Network Matrix Factorization. Theoretical "
                        "generalization of DeepWalk."},
        {"name": "grarep", "function": "embed_grarep",
         "description": "GraRep: Multi-scale matrix factorization with k-step "
                        "transitions."},
        {"name": "deepwalk", "function": "embed_deepwalk",
         "description": "DeepWalk: Random walk + SVD. The original graph "
                        "embedding algorithm."},
        {"name": "node2vec", "function": "embed_node2vec",
         "description": "Node2Vec: Biased random walk with p,q parameters "
                        "controlling BFS/DFS balance."},
    ]
