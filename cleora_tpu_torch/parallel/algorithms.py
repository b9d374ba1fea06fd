"""The spectral siblings over the shard group: ProNE, RandNE, HOPE, NetMF
and GraRep with ``mesh=``/``n_devices=``.

The port of cleora_tpu/parallel/algorithms.py.  The graph is cut into the
canonical row blocks (:mod:`.shard`), one shard per rank of the process
group (:mod:`.mesh`; without a group the calling process is the one
shard), and each rank holds its (rows_per_shard, d) rows of every state on
its own device.  The JAX package's jitted ``shard_map`` bodies become host
loops here, as in :mod:`.embed`:

* the operator ``y = T @ x`` (:class:`ShardedOp`) is the exchange (the
  all-gather, or the halo exchange with kernel K16 when it moves fewer
  rows) followed by kernel K1 on the shard's local CSR, or kernel K5 with
  the step's elementwise tail, whose ``b·x`` term reads the shard's own
  rows (K5's ``self_`` operand) while the SpMM gathers from the table;
* thin QR of a row-sharded (n, r) matrix is CholeskyQR2 (two passes of an
  all-reduced r×r Gram, a Cholesky factor and a triangular solve), and
  U_k·√S_k and the small SVD come from the all-reduced Gram matrix and an
  ``eigh`` that every rank repeats — full-float32 library calls, as the
  port's rule for dense linear algebra says (the r×r work is negligible);
* NetMF's and GraRep's (n, r) sketch panels stay as each rank's rows on its
  device; a (b, r) block of a panel is one all-reduce of a buffer to which
  each rank writes the rows it owns, and a block's (b, r) product is kept
  by each rank for the rows in its own range;
* NetMF's log-clip is kernel K7 with the shard's degrees as the row scale.

ProNE and RandNE also run from a full DiskGraph (the shard's rows read off
the memmaps) and, with a group, from each rank's own piece of a sharded
build; HOPE, NetMF and GraRep need the transposed operator, which a piece
cannot give, and raise for one.  Results are the pre-``_finalize`` float64
(n, d) matrix on every rank, or with ``out=`` the finalized float32 rows
streamed into one ``.npy`` shard by shard.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._util import full_float32_matmul, to_host
from ..algorithms import (
    _GRAREP_FLOOR,
    _GRAREP_OFFSET,
    _block_shape,
    _coo_f32,
    _finalize,
    _pt_values,
    _sym_normalized_vals,
)
from ..ops.dense import log_clip
from ..ops.spmm import spmm_axpy
from .embed import (
    _propagate_local,
    check_piece_range,
    gather_table,
    shard_operator,
)
from .mesh import ShardGroup, make_mesh
from .shard import ShardedCsr, plan_halo, plan_halo_distributed, shard_csr
from .state import shard_rows, write_memmap


def _mesh_for(mesh, n_devices, device) -> ShardGroup:
    if mesh is None:
        return make_mesh(n_devices, device)
    if not isinstance(mesh, ShardGroup):
        raise TypeError(
            "mesh= takes a cleora_tpu_torch.parallel.ShardGroup (from "
            f"parallel.make_mesh()), got {type(mesh).__name__}"
        )
    return mesh


def _piece_range_of(graph):
    """(lo, hi) when ``graph`` is one host's piece of a sharded build,
    else None."""
    pr = (graph.meta.get("row_range")
          if getattr(graph, "meta", None) else None)
    if pr is None:
        return None
    lo, hi = int(pr[0]), int(pr[1])
    if lo > 0 or hi < graph.num_entities:
        return lo, hi
    return None


def _reject_piece(graph, name: str) -> None:
    if _piece_range_of(graph) is not None:
        raise ValueError(
            f"{name} applies the TRANSPOSED operator, which a per-host "
            "sharded-build piece cannot provide (a piece holds a row "
            "range; the transpose's rows are scattered across every "
            "piece) — merge the pieces first "
            "(graph.stream.merge_disk_graph_shards) or use prone/randne, "
            "which run directly from pieces."
        )


def _sharded_csr(rows, cols, vals, n: int, n_shards: int) -> ShardedCsr:
    """The :class:`ShardedCsr` of an (n, n) COO whose rows are sorted."""
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(np.asarray(rows, dtype=np.int64), minlength=n),
              out=indptr[1:])
    return ShardedCsr(indptr, np.asarray(cols, dtype=np.int32),
                      np.asarray(vals, dtype=np.float32), n, n_shards)


def _transpose_csr(rows, cols, vals, n: int, n_shards: int) -> ShardedCsr:
    """The :class:`ShardedCsr` of Aᵀ for a COO of A (each row of Aᵀ keeps
    A's row order, as ``CsrMatrix.transpose_from_coo``)."""
    order = np.argsort(cols, kind="stable")
    return _sharded_csr(np.asarray(cols)[order], np.asarray(rows)[order],
                        np.asarray(vals)[order], n, n_shards)


class ShardedOp:
    """This process's shard of a row-sharded linear operator ``y = T @ x``.

    ``x`` is the shard's (rows_per_shard, d) float32 rows.  The exchange is
    the JAX package's choice (``ShardedOp._finish``): the halo exchange
    when there is more than one shard and its gather table is smaller than
    the all-gathered one, else the all-gather; ``piece=True`` plans the
    halo from this rank's own edges only (:func:`.shard.plan_halo_distributed`).
    ``vals`` replaces the shard's values (the sym-normalized ones)."""

    def __init__(self, mesh: ShardGroup, sharded: ShardedCsr, width: int,
                 piece: bool = False, vals: Optional[np.ndarray] = None):
        self.mesh = mesh
        self.sharded = sharded
        self.rows_per_shard = sharded.rows_per_shard
        self.plan = None
        if mesh.world_size > 1:
            cand = (plan_halo_distributed(sharded, mesh) if piece
                    else plan_halo(sharded))
            if cand.table_rows < sharded.n_rows_padded:
                self.plan = cand
        self.csr, self.send_idx = shard_operator(mesh, sharded, self.plan,
                                                 width, vals=vals)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """The shard's rows of ``T @ x``: the exchange, then K1."""
        return _propagate_local(x, self.csr, self.mesh, self.send_idx, 0.0)

    def apply_axpy(self, x: torch.Tensor, a: float, b: float = 0.0,
                   z: Optional[torch.Tensor] = None, c: float = 0.0,
                   acc: Optional[torch.Tensor] = None,
                   d: float = 0.0) -> torch.Tensor:
        """The shard's rows of ``a·(T @ x) + b·x + c·z`` (and ``acc +=
        d·out``): the exchange, then K5 on the gather table with the
        ``b·x`` term read from the shard's own rows."""
        table = gather_table(x, self.mesh, self.send_idx)
        return spmm_axpy(self.csr, table, a, b, z, c, acc, d,
                         self_=None if table is x else x)

    def own_rows(self, full: np.ndarray) -> torch.Tensor:
        """This shard's rows (zero-padded) of a host (..., n, d) matrix,
        as float32 on its device."""
        rps = self.rows_per_shard
        lo, hi = shard_rows(self.mesh, self.sharded.n_rows, rps)
        out = np.zeros(full.shape[:-2] + (rps, full.shape[-1]), np.float32)
        out[..., :hi - lo, :] = full[..., lo:hi, :]
        return torch.from_numpy(out).to(self.mesh.device)


# ------------------------------------------------------ distributed linalg
# Callers run these under _util.full_float32_matmul: the JAX package pins
# Precision.HIGHEST on the same products.  A leading batch axis (GraRep's
# one panel per step) passes through.
def _psum_gram(y: torch.Tensor, mesh: ShardGroup) -> torch.Tensor:
    """yᵀy over every shard's rows: a local product, all-reduced."""
    return mesh.all_reduce_(torch.matmul(y.mT, y))


def _chol_qr(y: torch.Tensor, mesh: ShardGroup) -> torch.Tensor:
    """Distributed thin QR of a row-sharded (n, r) matrix: CholeskyQR2
    (two Gram/Cholesky/solve passes; the r×r work is repeated on every
    rank).  Returns the shard's rows of Q, row-major."""
    r = y.shape[-1]
    eye = torch.eye(r, dtype=y.dtype, device=y.device)
    for _ in range(2):
        g = _psum_gram(y, mesh)
        trace = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
        eps = 1e-10 * trace / r + 1e-30
        low = torch.linalg.cholesky(g + eps[..., None, None] * eye)
        # y ← y·L⁻ᵀ, JAX's solve_triangular(L, yᵀ, lower=True)ᵀ
        y = torch.linalg.solve_triangular(low.mT, y, upper=True, left=False)
    return y.contiguous()


def _gram_usqrt(U: torch.Tensor, mesh: ShardGroup) -> torch.Tensor:
    """Distributed U_k·√S_k of a row-sharded matrix: eigh of the
    all-reduced Gram gives V and s² = λ, and U_k·√S_k = U·V·diag(s^-½)
    (the single-device ``_svd_sqrt`` up to per-column signs)."""
    lam, V = torch.linalg.eigh(_psum_gram(U, mesh))
    lam, V = lam.flip(-1), V.flip(-1)
    s = torch.sqrt(torch.clamp_min(lam, 0.0))
    scale = torch.where(s > 1e-12,
                        1.0 / torch.sqrt(torch.clamp_min(s, 1e-12)),
                        torch.zeros_like(s))
    return torch.matmul(U, V * scale)


# ------------------------------------------------------------ run plumbing
def _sym_normalized_shard_vals(sharded: ShardedCsr,
                               mesh: ShardGroup) -> np.ndarray:
    """This shard's values of D^-1/2 A D^-1/2.  Row degrees are summed over
    the shard's own rows in float64 and all-reduced into the global
    (n_padded,) vector (row ownership is disjoint, so the sum is exact):
    the values need ``dis`` at column positions too."""
    k, rps = mesh.rank, sharded.rows_per_shard
    vals = np.asarray(sharded.vals[k], dtype=np.float64)
    local = np.repeat(np.arange(rps, dtype=np.int64),
                      np.diff(sharded.indptr(k)))
    deg = np.zeros(sharded.n_rows_padded, dtype=np.float64)
    deg[k * rps:(k + 1) * rps] = np.bincount(local, weights=vals,
                                             minlength=rps)
    deg = mesh.all_reduce_(torch.from_numpy(deg).to(mesh.device)).cpu()
    dis = 1.0 / np.sqrt(np.maximum(deg.numpy(), 1e-10))
    cols = np.asarray(sharded.cols[k], dtype=np.int64)
    return (dis[k * rps + local] * vals * dis[cols]).astype(np.float32)


def _sharded_op_sym(graph, mesh: ShardGroup, width: int) -> ShardedOp:
    """Symmetric-normalized ShardedOp for ProNE/RandNE, from a full in-RAM
    graph, a full DiskGraph (the shard's rows read off its memmaps), or,
    with a group, this rank's PIECE of a sharded build, which must cover
    exactly the rank's shard."""
    n = graph.num_entities
    P = mesh.world_size
    pr = _piece_range_of(graph)
    if pr is None:
        if hasattr(graph, "to_sparse_csr"):
            rows, cols, vals, n, _ = graph.to_sparse_csr()
            nvals = _sym_normalized_vals(rows, cols, vals, n)
            return ShardedOp(mesh, _sharded_csr(rows, cols, nvals, n, P),
                             width)
        sharded = shard_csr(graph, "left", P)
        return ShardedOp(mesh, sharded, width,
                         vals=_sym_normalized_shard_vals(sharded, mesh))
    if P == 1:
        raise ValueError(
            "This DiskGraph is one host's piece of a sharded build "
            f"(rows {pr}); running a sharded algorithm on it needs either "
            "the merged graph (graph.stream.merge_disk_graph_shards) or a "
            "multi-process run where every host holds its own piece."
        )
    check_piece_range(*pr, n, mesh)
    sharded = shard_csr(graph, "left", P)
    return ShardedOp(mesh, sharded, width, piece=True,
                     vals=_sym_normalized_shard_vals(sharded, mesh))


def _sharded_exit(x: torch.Tensor, op: ShardedOp, n: int, feature_dim: int,
                  out: Optional[str]):
    """The full pre-``_finalize`` (n, d) float64 matrix on every rank, or
    with ``out=`` the finalized float32 rows streamed into one ``.npy``
    in bounded chunks per shard (the finalize is row-local, so applying it
    per chunk is exact)."""
    if out is None:
        return to_host(op.mesh.all_gather(x)[:n]).astype(np.float64)
    return write_memmap(
        out, x, op.mesh, n, op.rows_per_shard,
        transform=lambda b: _finalize(b.astype(np.float64), feature_dim))


# -------------------------------------------------------------- algorithms
@full_float32_matmul()
def prone_sharded(graph, feature_dim, mu, theta, seed, mesh=None,
                  n_devices=None, out=None, device=None):
    """Sharded ProNE: the Chebyshev recurrence (K5 per term) and the
    U_k√S_k epilogue from the all-reduced Gram.  Returns the
    pre-``_finalize`` (n, feature_dim) float64 matrix, the single-device
    result up to per-column signs."""
    mesh = _mesh_for(mesh, n_devices, device)
    n = graph.num_entities
    op = _sharded_op_sym(graph, mesh, feature_dim)
    rng = np.random.default_rng(seed)
    R = op.own_rows(rng.standard_normal((n, feature_dim)).astype(np.float32))
    theta32, mu32 = np.float32(theta), np.float32(mu)
    U = R.clone()
    prev = R
    curr = op.apply_axpy(R, -1.0, 1.0)  # L·R = R − N·R
    for k in range(2, min(10, n)):
        coeff = float(np.exp(-theta32 * np.float32(k)) * mu32)
        # nxt = 2·L·curr − prev; U += coeff·nxt
        nxt = op.apply_axpy(curr, -2.0, 2.0, z=prev, c=-1.0, acc=U, d=coeff)
        prev, curr = curr, nxt
    del prev, curr
    return _sharded_exit(_gram_usqrt(U, mesh), op, n, feature_dim, out)


def randne_sharded(graph, feature_dim, weights, seed, mesh=None,
                   n_devices=None, out=None, device=None):
    """Sharded RandNE Σ_i w_i·N^i·R, one K5 per power.  Returns the
    pre-``_finalize`` (n, feature_dim) float64 matrix."""
    mesh = _mesh_for(mesh, n_devices, device)
    n = graph.num_entities
    op = _sharded_op_sym(graph, mesh, feature_dim)
    rng = np.random.default_rng(seed)
    x = op.own_rows(rng.standard_normal((n, feature_dim)).astype(np.float32))
    w = np.asarray(weights, dtype=np.float32)
    acc = float(w[0]) * x
    for wi in w[1:]:
        x = op.apply_axpy(x, 1.0, acc=acc, d=float(wi))
    return _sharded_exit(acc, op, n, feature_dim, out)


@full_float32_matmul()
def hope_sharded(graph, feature_dim, beta, seed, oversample, power_iters,
                 mesh=None, n_devices=None, out=None, device=None):
    """Sharded matrix-free HOPE: the Katz Neumann series as K5 steps on A
    and Aᵀ, subspace iteration with CholeskyQR2, the small SVD from the
    all-reduced r×r Gram.  Returns the pre-``_finalize`` (n, 2k) float64
    matrix, the single-device result up to joint source/target column
    signs."""
    _reject_piece(graph, "hope_sharded")
    mesh = _mesh_for(mesh, n_devices, device)
    rows, cols, vals, n, _ = graph.to_sparse_csr()
    rows = rows.astype(np.int32)
    cols = cols.astype(np.int32)
    vals = vals.astype(np.float32)

    # the single-device backend's series sizing (algorithms.py)
    row_sums = np.zeros(n, dtype=np.float64)
    np.add.at(row_sums, rows.astype(np.int64),
              np.abs(vals.astype(np.float64)))
    beta_norm = beta * float(row_sums.max(initial=0.0))
    if beta_norm >= 1.0:
        raise ValueError(
            f"backend='device' needs beta * ||A||_inf < 1 for the Neumann "
            f"series to converge (got {beta_norm:.3f}); use backend='host' "
            f"or a smaller beta"
        )
    terms = (
        int(np.ceil(np.log(1e-12) / np.log(beta_norm))) if beta_norm > 0
        else 1
    )
    terms = max(2, min(terms, 128))
    k = min(feature_dim // 2, n - 1)
    r = min(n, k + oversample)

    P = mesh.world_size
    op_a = ShardedOp(mesh, _sharded_csr(rows, cols, vals, n, P), r)
    op_t = ShardedOp(mesh, _transpose_csr(rows, cols, vals, n, P), r)
    rng = np.random.default_rng(seed)
    omega = op_a.own_rows(rng.standard_normal((n, r)).astype(np.float32))

    def katz(op, x):
        """Σ_{k=1..terms} β^k T^k x, one K5 per term."""
        acc = torch.zeros_like(x, memory_format=torch.contiguous_format)
        cur = x
        for _ in range(terms):
            cur = op.apply_axpy(cur, beta, acc=acc, d=1.0)
        return acc

    Y = katz(op_a, omega)
    for _ in range(power_iters):
        Q = _chol_qr(Y, mesh)
        Y = katz(op_a, katz(op_t, Q))
    Q = _chol_qr(Y, mesh)
    C = katz(op_t, Q)  # the shard's rows of the projected operator
    lam, Ub = torch.linalg.eigh(_psum_gram(C, mesh))  # CᵀC = Ub·S²·Ubᵀ
    lam, Ub = lam.flip(-1), Ub.flip(-1)
    s = torch.sqrt(torch.clamp_min(lam, 0.0))
    sinv = torch.where(s > 1e-12, 1.0 / torch.clamp_min(s, 1e-12),
                       torch.zeros_like(s))
    V = torch.matmul(C, Ub * sinv)  # the shard's rows of the right vectors
    su = torch.sqrt(s[:k])
    left = torch.matmul(Q, Ub[:, :k]) * su
    right = V[:, :k] * su
    return _sharded_exit(torch.cat([left, right], dim=1), op_a, n,
                         feature_dim, out)


# ------------------------------------------------------ blocked log panels
def _block_seed_local(rps: int, b: int, base: int, start: int, n: int,
                      device) -> torch.Tensor:
    """One-hot seed of a block of probe columns, the shard's rows only:
    column j holds e_{start+j} (for start + j < n) restricted to the rows
    [base, base + rps)."""
    y = torch.zeros((rps, b), dtype=torch.float32, device=device)
    lo, hi = max(start, base), min(start + b, n, base + rps)
    if hi > lo:
        g = torch.arange(lo, hi, device=device)
        y[g - base, g - start] = 1.0
    return y


def _overlap(base: int, rps: int, start: int, b: int):
    """Global rows [lo, hi) that block [start, start + b) shares with the
    shard's rows [base, base + rps)."""
    return max(start, base), min(start + b, base + rps)


def _vblock(V: torch.Tensor, mesh: ShardGroup, base: int, start: int,
            b: int) -> torch.Tensor:
    """Rows [start, start + b) of the row-sharded panel V on every rank:
    each rank writes the rows it owns into a zero (..., b, r) buffer and
    one all-reduce sums the disjoint parts."""
    out = V.new_zeros(V.shape[:-2] + (b, V.shape[-1]))
    lo, hi = _overlap(base, V.shape[-2], start, b)
    if hi > lo:
        out[..., lo - start:hi - start, :] = V[..., lo - base:hi - base, :]
    return mesh.all_reduce_(out)


def _sweep(block, mesh: ShardGroup, base: int, rps: int, n: int, b: int,
           W: Optional[torch.Tensor], V: Optional[torch.Tensor]):
    """One sweep over the row blocks of M: ``block(start, W, Vb)`` returns
    the shard's parts of a block's (Lᵀ·W, L·Vb); the sweep returns the
    shard's rows of (M·W, Mᵀ·V).  Each block's Lᵀ·W is all-reduced and
    every rank keeps the rows in its own range.  An operand that is None
    is skipped and its product comes back None."""
    Y = None if W is None else torch.zeros_like(W)
    G = None
    for start in range(0, -(-n // b) * b, b):
        Vb = None if V is None else _vblock(V, mesh, base, start, b)
        br, nr = block(start, W, Vb)
        if br is not None:
            mesh.all_reduce_(br)
            lo, hi = _overlap(base, rps, start, b)
            if hi > lo:
                Y[..., lo - base:hi - base, :] = br[..., lo - start:hi - start,
                                                    :]
        if nr is not None:
            G = nr if G is None else G.add_(nr)
    return Y, G


def _blocked_u_sqrt(sweep, mesh: ShardGroup, k: int, power_iters: int,
                    omega: torch.Tensor) -> torch.Tensor:
    """The shard's rows of U_k·√S_k of M by randomized subspace iteration
    over the sweeps (2 + 2·power_iters of them); the small eigh runs on the
    host in float64, as the JAX package's does."""
    Y, _ = sweep(omega, None)
    for _ in range(power_iters):
        Q = _chol_qr(Y, mesh)
        _, G = sweep(None, Q)
        Y, _ = sweep(G, None)
    Q = _chol_qr(Y, mesh)
    _, C = sweep(None, Q)
    # CᵀC = Ub·S²·Ubᵀ; the result does not depend on Q's column signs
    gram = _psum_gram(C, mesh).cpu().numpy().astype(np.float64)
    M = np.zeros(gram.shape[:-1] + (k,), np.float32)
    for idx in np.ndindex(gram.shape[:-2]):
        lam, Ub = np.linalg.eigh(gram[idx])
        order = np.argsort(lam)[::-1]
        su = np.power(np.maximum(lam[order][:k], 0.0), 0.25)
        M[idx] = (Ub[:, order][:, :k] * su[None, :]).astype(np.float32)
    return torch.matmul(Q, torch.from_numpy(M).to(Q.device))


@full_float32_matmul()
def netmf_sharded(graph, feature_dim, window_size, negative_samples, seed,
                  oversample, power_iters, block_rows=None, mesh=None,
                  n_devices=None, out=None, device=None):
    """Sharded blocked NetMF: the log-PMI matrix exists one block of
    columns at a time, each as the shard's rows: ``window`` K5 steps of
    the one-hot seed over Pᵀ, K7 for the log-clip, and the two sketch
    products (Lᵀ·W all-reduced, L·Vb local).  Returns the
    pre-``_finalize`` (n, feature_dim) float64 matrix."""
    _reject_piece(graph, "netmf_sharded")
    mesh = _mesh_for(mesh, n_devices, device)
    dev = mesh.device
    rows, cols, vals, n = _coo_f32(graph)
    pt_vals, deg, vol = _pt_values(rows, vals, n)
    k = min(feature_dim, n)
    r = min(n, k + oversample)
    b = _block_shape(n, r, block_rows, dev)
    window = max(1, window_size)
    op = ShardedOp(mesh, _transpose_csr(rows, cols, pt_vals, n,
                                        mesh.world_size), b)
    rps = op.rows_per_shard
    base = mesh.rank * rps
    scale = np.float32(vol / (negative_samples * window))
    deg_dev = torch.from_numpy(deg).to(dev)
    # s_col[i] = scale/deg[i]; 0 on the padded tail, where acc is 0 as well
    s_col = torch.zeros(n + b, dtype=torch.float32, device=dev)
    s_col[:n] = float(scale) / deg_dev
    # the shard's degrees as K7's row scale; its pad rows hold acc == 0
    deg_own = op.own_rows(deg[:, None])[:, 0].contiguous()

    def block(start: int, W, Vb):
        y = _block_seed_local(rps, b, base, start, n, dev)
        acc = torch.zeros_like(y)
        for _ in range(window):
            y = op.apply_axpy(y, 1.0, acc=acc, d=1.0)
        L = log_clip(acc, deg_own, s_col[start:start + b].contiguous(),
                     1.0, 0.0)
        return (None if W is None else torch.matmul(L.T, W),
                None if Vb is None else torch.matmul(L, Vb))

    def sweep(W, V):
        return _sweep(block, mesh, base, rps, n, b, W, V)

    rng = np.random.default_rng(seed)
    omega = op.own_rows(rng.standard_normal((n, r)).astype(np.float32))
    res = _blocked_u_sqrt(sweep, mesh, k, power_iters, omega)
    return _sharded_exit(res, op, n, feature_dim, out)


@full_float32_matmul()
def grarep_sharded(graph, feature_dim, max_step, seed, oversample,
                   power_iters, block_rows=None, mesh=None, n_devices=None,
                   out=None, device=None):
    """Sharded blocked GraRep: one transition-power walk of the block's
    one-hot seed (K1 per step) serves every step's log block (K7), each
    step with its own (max_step, n, r) panel slice.  Returns the
    pre-``_finalize`` (n, max_step·k) float64 matrix."""
    _reject_piece(graph, "grarep_sharded")
    mesh = _mesh_for(mesh, n_devices, device)
    dev = mesh.device
    rows, cols, vals, n = _coo_f32(graph)
    pt_vals, _, _ = _pt_values(rows, vals, n)
    k = min(max(feature_dim // max_step, 1), n)
    r = min(n, k + oversample)
    b = _block_shape(n, r, block_rows, dev)
    op = ShardedOp(mesh, _transpose_csr(rows, cols, pt_vals, n,
                                        mesh.world_size), b)
    rps = op.rows_per_shard
    base = mesh.rank * rps

    def block(start: int, W, Vb):
        y = _block_seed_local(rps, b, base, start, n, dev)
        brs, nrs = [], []
        for s in range(max_step):
            y = op.apply(y)
            # K7 clips in place: the walk goes on from a copy's original
            last = s + 1 == max_step
            L = log_clip(y if last else y.clone(), None, None, _GRAREP_FLOOR,
                         _GRAREP_OFFSET)
            if W is not None:
                brs.append(torch.matmul(L.T, W[s]))
            if Vb is not None:
                nrs.append(torch.matmul(L, Vb[s]))
        return (torch.stack(brs) if brs else None,
                torch.stack(nrs) if nrs else None)

    def sweep(W, V):
        return _sweep(block, mesh, base, rps, n, b, W, V)

    rng = np.random.default_rng(seed)
    omega = op.own_rows(
        rng.standard_normal((max_step, n, r)).astype(np.float32))
    res = _blocked_u_sqrt(sweep, mesh, k, power_iters, omega)
    # (max_step, rps, k) → (rps, max_step·k)
    res = res.permute(1, 0, 2).reshape(rps, max_step * k)
    return _sharded_exit(res, op, n, feature_dim, out)
