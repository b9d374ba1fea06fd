"""K5's banded kernel and K12's record and window form, on the CPU.

The kernels run only on the card (``tests/test_torch_kernels.py`` holds
them bitwise the short-row kernel and the plain walk there).  Here:

* ``kernels.band_columns``, the one place that chooses K5's band: at NetMF's
  blocked panel, at ProNE's 200,000-node shape, at ``embed()``'s shape and
  at the edges of its budget and width;
* K12's head records, bitwise the tables' ``indptr``/``deg``/``wmax``/
  ``wsum``, and the window lookup's arithmetic restated in numpy (lower
  bound's steps until the aligned window holds the rest, then the first
  position in the window): it finds lower_bound's position in every row;
* the plain versions against the JAX package: K5's (the blocked NetMF walk
  ``y = Pᵀ·y; acc += y``, ``cleora_tpu/algorithms.py:595-597``) at
  rtol=1e-5, atol=1e-6 (float32 sums in another order than the ELL
  buckets'); K12's by a χ² test of both samplers' second hops against the
  exact Node2Vec law (p-value ≥ 1e-3), the port's walks taken through
  ``ops.walk.walk_p_q`` with the head records and bitwise its plain
  version.
"""

import numpy as np
import pytest
import torch
from scipy.stats import chisquare

import cleora_tpu.algorithms as jalg
import cleora_tpu_torch.algorithms as talg
from cleora_tpu_torch import kernels
from cleora_tpu_torch.ops import walk as twalk
from cleora_tpu_torch.ops.spmm import spmm_axpy, spmm_axpy_plain
from torch_test_support import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
BUDGET = kernels.BAND_L2_BYTES


# ----------------------------------------------------- K5's band choice
BAND = kernels.BAND_COLUMNS
MIN = kernels.BAND_MIN_WIDTH


@pytest.mark.parametrize("x_rows,width,want", [
    (200_000, 4096, BAND),              # NetMF's blocked panel
    (200_000, 1024, BAND),
    (200_000, 256, BAND),               # ProNE on a 200,000-node graph
    (1_958_363, 256, 0),                # embed() and the Chebyshev siblings
    (1_958_363, 4096, 0),               # a band of 32 columns is 250 MB
    (BUDGET // (4 * BAND), 4096, BAND),  # a band fills the budget exactly
    (BUDGET // (4 * BAND) + 1, 4096, 0),  # one row more
    (200_000, MIN - 4, 0),              # too narrow
    (200_000, MIN, BAND),
    (BUDGET // (4 * 4096), 4096, 0),    # the whole x fits the budget
    (BUDGET // (4 * 4096) + 1, 4096, BAND),
    (20_000, 256, 0),                   # 20.5 MB: x fits whole
])
def test_band_columns_choice(x_rows, width, want):
    assert kernels.band_columns(x_rows, width) == want


def test_band_is_whole_128_byte_lines_of_a_row():
    assert BAND % 32 == 0 and BAND * 4 % 128 == 0
    assert 4 * 200_000 * BAND <= BUDGET < 4 * 1_958_363 * 8


# --------------------------------------------------- K12's head records
def _weighted_tables(n, seed, hub_degree):
    rng = np.random.default_rng(seed)
    m = 3 * n
    src = np.concatenate([rng.integers(0, n - 1, m),
                          np.ones(hub_degree, np.int64)])
    dst = np.concatenate([rng.integers(0, n - 1, m),
                          rng.choice(n - 1, hub_degree, replace=False)])
    keys = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    rows, cols = keys // n, keys % n
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(0.05, 3.0, rows.shape[0]).astype(np.float32)
    deg = np.bincount(rows, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)[:-1]])
    wmax = np.zeros(n, np.float32)
    np.maximum.at(wmax, rows, vals)
    wsum = np.zeros(n, np.float64)
    np.add.at(wsum, rows, vals.astype(np.float64))
    return twalk.WalkTables2(indptr, cols, deg, n, vals, wmax,
                             wsum.astype(np.float32), CPU)


def test_head_records_are_the_tables_bitwise():
    t = _weighted_tables(500, 1, 200)
    head = t.head
    assert head.dtype == torch.int32 and head.shape == (t.n, 4)
    assert head.is_contiguous() and head.device == t.indptr.device
    assert torch.equal(head[:, 0], t.indptr)
    assert torch.equal(head[:, 1], t.deg)
    assert torch.equal(head[:, 2].view(torch.float32), t.wmax)
    assert torch.equal(head[:, 3].view(torch.float32), t.wsum)
    assert torch.equal(kernels.walk_head(t.indptr, t.deg, t.wmax, t.wsum),
                       head)


def test_k12_wrapper_checks_the_head_records():
    t = _weighted_tables(50, 2, 0)
    starts = torch.zeros(4, dtype=torch.int32)
    kernels.reset_launches()
    for bad in (t.head[:-1], t.head.float(), t.head[:, :3]):
        with pytest.raises(ValueError, match="head must be"):
            kernels.walk_p_q(bad, t.cols, t.vals, starts, 5, 1.0, 1.0, 64, 0,
                             0, t.n)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.walk_p_q(t.head, t.cols, t.vals, starts, 5, 1.0, 1.0, 64, 0,
                         0, t.n)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


WINDOW = 32  # walk2_hop.cuh kWindow


def _row_find(cols, lo, end, x):
    """walk2_hop.cuh row_find in numpy: lower_bound's steps until the
    window at lo rounded down to 4 holds [lo, min(hi + 1, end)), then the
    first position of the window in that range whose column is >= x (the
    range's end when none), and whether its column is x."""
    hi = end
    while (hi + 1 if hi < end else end) > (lo & ~3) + WINDOW:
        mid = lo + ((hi - lo) >> 1)
        if cols[mid] < x:
            lo = mid + 1
        else:
            hi = mid
    hi = hi + 1 if hi < end else end
    base = lo & ~3
    at = np.arange(base, base + WINDOW)
    ok = (at >= lo) & (at < hi)
    ok[ok] &= cols[at[ok]] >= x
    if not ok.any():
        return hi, False
    pos = int(at[ok][0])
    return pos, bool(cols[pos] == x)


def test_window_lookup_finds_lower_bounds_position():
    t = _weighted_tables(400, 3, 300)  # row 1 a hub of 300 entries
    cols = np.concatenate([t.cols.numpy(), np.zeros(WINDOW, np.int32)])
    indptr, deg = t.indptr.numpy(), t.deg.numpy()
    rng = np.random.default_rng(4)
    long_rows = 0
    for r in range(t.n):
        lo, hi = int(indptr[r]), int(indptr[r] + deg[r])
        long_rows += hi > (lo & ~3) + WINDOW
        row = cols[lo:hi]
        probes = np.concatenate([row, row + 1, rng.integers(0, t.n, 4),
                                 [-1, t.n]])
        for x in probes:
            want = lo + int(np.searchsorted(row, x, side="left"))
            hit = want < hi and cols[want] == x
            assert _row_find(cols, lo, hi, int(x)) == (want, hit), (r, x)
    assert long_rows >= 1


# ------------------------------------------- the plain versions vs JAX
def test_k5_plain_walk_matches_the_jax_blocked_netmf_walk():
    import jax.numpy as jnp
    from cleora_tpu.ops.spmm_ell import spmm_ell

    rng = np.random.default_rng(16)
    n, b, window = 300, 64, 5
    src, dst = rng.integers(0, n, 1200), rng.integers(0, n, 1200)
    keys = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    rows, cols = (keys // n).astype(np.int32), (keys % n).astype(np.int32)
    vals = rng.uniform(0.5, 2.0, rows.shape[0]).astype(np.float32)
    plan, _, _ = jalg._pt_ell_plan(rows, cols, vals, n)
    csr, _, _ = talg._pt_csr(rows, cols, vals, n, CPU)
    rank = np.asarray(plan.rank)[:n]
    iota = np.arange(b)
    y_j = jnp.zeros((n, b), jnp.float32).at[rank[iota], iota].add(1.0)
    acc_j = jnp.zeros((n, b), jnp.float32)
    y = talg._one_hot_block(n, b, 0, CPU)
    acc = torch.zeros_like(y)
    acc_ops = torch.zeros_like(y)
    for _ in range(window):
        y_j = spmm_ell(plan, y_j)
        acc_j = acc_j + y_j
        y_ops = spmm_axpy(csr, y, 1.0, acc=acc_ops, d=1.0)
        y = spmm_axpy_plain(csr, y, 1.0, acc=acc, d=1.0)
        assert torch.equal(y_ops, y) and torch.equal(acc_ops, acc)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j)[rank], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j)[rank],
                               rtol=1e-5, atol=1e-6)


def _triangles():
    """A weighted graph of three triangles and a path, as a neighbour dict
    and as the walk CSR's arrays (rows (row, col)-sorted)."""
    edges = [(0, 1, 1.0), (0, 2, 2.0), (1, 2, 0.5), (1, 3, 3.0), (2, 3, 1.0),
             (2, 4, 1.5), (3, 4, 2.0), (0, 5, 1.0), (5, 6, 0.7), (4, 6, 1.2)]
    n = 7
    adj = {i: {} for i in range(n)}
    for a, c, w in edges:
        adj[a][c] = adj[c][a] = w
    rows = np.array([r for r in range(n) for _ in adj[r]])
    cols = np.array([c for r in range(n) for c in sorted(adj[r])], np.int32)
    vals = np.array([adj[r][c] for r in range(n) for c in sorted(adj[r])],
                    np.float32)
    deg = np.bincount(rows, minlength=n).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int32)
    wmax = np.zeros(n, np.float32)
    np.maximum.at(wmax, rows, vals)
    wsum = np.zeros(n)
    np.add.at(wsum, rows, vals.astype(np.float64))
    return adj, (indptr, cols, vals, deg, wmax, wsum.astype(np.float32)), n


def _chi_square_p(walks, adj, s, p, q):
    """p-value of the second hops of walks from ``s`` against the exact
    law: a uniform first hop, then ``w·α / Σ w·α``."""
    cells, probs = [], []
    for cur in sorted(adj[s]):
        nbrs = sorted(adj[cur])
        w = np.array([adj[cur][x] for x in nbrs])
        alpha = np.array([1.0 / p if x == s else
                          (1.0 if x in adj[s] else 1.0 / q) for x in nbrs])
        for x, pr in zip(nbrs, w * alpha / np.sum(w * alpha)):
            cells.append((cur, x))
            probs.append(pr / len(adj[s]))
    observed = np.array([np.sum((walks[:, 1] == a) & (walks[:, 2] == c))
                         for a, c in cells])
    assert observed.sum() == walks.shape[0]
    return chisquare(observed, np.array(probs) * walks.shape[0]).pvalue


def test_k12_plain_walks_follow_the_law_as_the_jax_walks_do():
    import jax
    import jax.numpy as jnp

    p, q, start, walks = 0.5, 2.0, 2, 20_000
    adj, tabs, n = _triangles()
    t = twalk.WalkTables2(tabs[0], tabs[1], tabs[3], n, tabs[2], tabs[4],
                          tabs[5], CPU)
    args = (torch.full((walks,), start, dtype=torch.int32), 3, 1.0 / p,
            1.0 / q, twalk.walk2_tries(q), 5, 0)
    ours = twalk.walk_p_q(t, *args)
    assert torch.equal(ours, twalk.walk_p_q_plain(
        t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum, *args, n))
    assert _chi_square_p(ours.numpy(), adj, start, p, q) >= 1e-3
    indptr, cols, vals, deg, wmax, wsum = (jnp.asarray(a) for a in tabs)
    theirs = np.asarray(jalg._device_walk2_jit()(
        indptr, cols, vals, deg, wmax, wsum,
        jnp.full((walks,), start, jnp.int32), jax.random.PRNGKey(5),
        jnp.float32(1.0 / p), jnp.float32(1.0 / q), walk_length=3, n_rows=n,
        tries=twalk.walk2_tries(q), bsteps=3, chunk=1))
    assert _chi_square_p(theirs, adj, start, p, q) >= 1e-3
