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
The walk-based siblings (DeepWalk, Node2Vec) are not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ._util import full_float32_matmul, resolve_device
from .ops import memory
from .ops.dense import dense_markov, log_clip, rsvd_u_sqrt
from .ops.spmm import CsrMatrix, spmm, spmm_axpy

_SHARDED_NOT_PORTED = (
    "mesh=/n_devices= (the sharded device backends) are not ported yet: "
    "they are the multi-GPU slice of the port (ROADMAP.md, queue A item 8)"
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


def _check_not_sharded(mesh, n_devices) -> None:
    if mesh is not None or n_devices is not None:
        raise NotImplementedError(_SHARDED_NOT_PORTED)


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
def _pt_csr(rows, cols, vals, n: int, device):
    """CSR of the TRANSPOSE transition operator Pᵀ (entries
    Pᵀ[j, i] = A[i, j]/deg[i]), plus deg and vol of A
    (cleora_tpu/algorithms.py:534-540; no relabelling: the CSR keeps
    original row order)."""
    deg64 = np.bincount(rows, weights=vals.astype(np.float64), minlength=n)
    vol = float(deg64.sum())
    deg = np.maximum(deg64, 1e-10).astype(np.float32)
    pt_vals = (vals / deg[rows]).astype(np.float32)
    return CsrMatrix.transpose_from_coo(rows, cols, pt_vals, n, device), deg, vol


def _auto_block_rows(n: int, r: int, limit=None,
                     device: Optional[torch.device] = None) -> int:
    """Largest block width, a multiple of 128, whose O(n·b) working set
    (three (n, b) f32 buffers + rSVD (n, r) operands) fits half the
    device."""
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
    tail columns of the last block stay 0)."""
    y = torch.zeros((n, b), dtype=torch.float32, device=device)
    width = min(b, n - start)
    j = torch.arange(width, device=device)
    y[start + j, j] = 1.0
    return y


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

    def block(start: int, W, V):
        """One walk serves ALL steps: at each power P^s the step's log
        block L_s feeds that step's pair of sketch products
        (cleora_tpu/algorithms.py:628-648).  The padded tail columns hold
        y == 0 → L == 0, so they need no masking."""
        y = _one_hot_block(n, b, start, dev)
        brs, nrs = [], []
        for s in range(max_step):
            y = spmm(csr_pt, y)
            # K7 clips in place: the walk goes on from a copy's original
            last = s + 1 == max_step
            L = log_clip(y if last else y.clone(), None, None, _GRAREP_FLOOR,
                         _GRAREP_OFFSET)
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
    host, as in the JAX package.  ``out=`` writes the finalized embedding to
    a ``.npy`` and returns a read-only memmap."""
    n = graph.num_entities

    if backend == "device":
        _check_not_sharded(mesh, n_devices)
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
    float32 (kernel K5).  ``out=`` writes the finalized embedding to a
    ``.npy`` and returns a read-only memmap."""
    n = graph.num_entities
    if weights is None:
        weights = [1.0 / (2**i) for i in range(num_iterations + 1)]
    # the reference reuses the last weight if the list is short
    full = [
        weights[i] if i < len(weights) else weights[-1]
        for i in range(num_iterations + 1)
    ]

    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, feature_dim))

    if backend == "device":
        _check_not_sharded(mesh, n_devices)
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
    ``out=`` writes the finalized embedding to a ``.npy`` and returns a
    read-only memmap."""
    n = graph.num_entities

    if backend == "device":
        _check_not_sharded(mesh, n_devices)
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
    path with that block width (auto-sized when None).  ``out=`` persists
    the finalized embedding to a ``.npy`` and returns a read-only memmap."""
    if backend == "device":
        _check_not_sharded(mesh, n_devices)
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
    the device.  ``block_rows`` forces the blocked path.  ``out=`` persists
    the finalized embedding to a ``.npy`` and returns a read-only memmap."""
    if backend == "device":
        _check_not_sharded(mesh, n_devices)
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
