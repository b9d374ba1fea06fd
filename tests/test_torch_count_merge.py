"""K10's merge form and K5's row plan on the CPU, against the JAX package.

The port chain-merges a partition's count ranges with K10's merge form (a
merge path over two sorted ranges); its plain version, which the CPU runs,
sorts the concatenation as the JAX package's ``_merge_impl`` does.  The
rsvd apply adds each PPMI piece over its own rows only (K5 with a row
plan).  Both are held here to the JAX programs on small inputs made with
numpy:

- merges: bitwise against ``cleora_tpu.ops.cooccur._merge_jit()`` (integer
  keys and counts, int32 counts wrapping modulo 2^32 in both);
- a sweep with chain merges over several batches: the ranges of the JAX
  ``_run_sweep`` bitwise, for 2 and 3 partitions;
- the rsvd apply over PPMI pieces: the JAX ``_rsvd_step_jits`` apply and
  apply_add within atol=1e-4 (float32 products summed in another order).
"""

import numpy as np
import pytest
import torch

import cleora_tpu.algorithms as jalg
from cleora_tpu.ops import cooccur as jco
from cleora_tpu_torch import kernels
from cleora_tpu_torch.ops import cooccur as tco
from cleora_tpu_torch.ops.dense import _apply_pieces
from cleora_tpu_torch.ops.spmm import CsrMatrix
from torch_test_support import one_torch_thread  # noqa: F401

N = 400


def _count_range(rng, m, lo=1, hi=50):
    pairs = np.unique(rng.integers(0, N * N, size=m))
    return (pairs // N).astype(np.int32), (pairs % N).astype(np.int32), \
        rng.integers(lo, hi, size=pairs.shape[0]).astype(np.int32)


def _ranges(case):
    rng = np.random.default_rng(5)
    a = _count_range(rng, 3000)
    if case == "disjoint":
        b = _count_range(rng, 3000)
        keep = ~np.isin(b[0].astype(np.int64) * N + b[1],
                        a[0].astype(np.int64) * N + a[1])
        b = tuple(t[keep] for t in b)
    elif case in ("identical", "wrap"):
        b = tuple(t.copy() for t in a)
        if case == "wrap":
            a = (a[0], a[1], np.full_like(a[2], 2**31 - 5))
    elif case == "interleaved":
        b = _count_range(rng, 4000)
    elif case == "empty_a":
        a, b = tuple(t[:0] for t in a), a
    else:  # empty_b
        b = tuple(t[:0] for t in a)
    return a, b


@pytest.mark.parametrize("case", ["disjoint", "identical", "interleaved",
                                  "empty_a", "empty_b", "wrap"])
def test_merge_plain_is_the_jax_merge(case):
    """K10's merge form's plain version (and ``_merge`` on the CPU) against
    the JAX package's merge program, entry for entry."""
    import jax.numpy as jnp

    a, b = _ranges(case)
    want = jco._merge_jit()(*(jnp.asarray(t) for t in (*a, *b)))
    m = int(want[3])
    ta = tuple(torch.from_numpy(t) for t in a) + (a[0].shape[0],)
    tb = tuple(torch.from_numpy(t) for t in b) + (b[0].shape[0],)
    for got in (tco.merge_plain(ta, tb, N), tco._merge(ta, tb, N)):
        assert got[3] == m
        for x, y in zip(got[:3], want[:3]):
            assert np.array_equal(x.numpy(), np.asarray(y)[:m])
    if case == "wrap":
        assert (got[2] < 0).any()  # 2^31 - 5 + 5 or more wraps


def _walks(rng, batches, batch, length, n):
    w = rng.integers(0, n, size=(batches * batch, length)).astype(np.int32)
    w[rng.random(w.shape) < 0.05] = n  # dead ends
    return [w[i * batch:(i + 1) * batch] for i in range(batches)]


@pytest.mark.parametrize("passes", [2, 3])
def test_sweep_and_merge_chain_give_the_jax_ranges(passes):
    """Per batch ``_reduce_sweep`` (K9, sort, K10's sweep form) and per
    partition a chain of ``_merge`` (K10's merge form): the JAX package's
    ``_run_sweep`` ranges, bitwise, over four batches."""
    import jax.numpy as jnp

    n, window = 120, 3
    chunks = _walks(np.random.default_rng(passes), 4, 48, 10, n)
    want = jco._run_sweep(lambda: ((jnp.asarray(c), 0) for c in chunks),
                          passes, n, window)
    got = tco._run_sweep(lambda: ((torch.from_numpy(c), 0) for c in chunks),
                         passes, n, window)
    assert len(got) == len(want) == passes
    for g, w in zip(got, want):
        m = int(w[3])
        assert g[3] == m > 0
        for x, y in zip(g[:3], w[:3]):
            assert np.array_equal(x.numpy(), np.asarray(y)[:m])


def test_apply_pieces_is_the_jax_rsvd_apply():
    """The rsvd apply over row-disjoint PPMI pieces (each piece added over
    its own rows into a zeroed product) against the JAX program's apply
    and apply_add on the same ranges and the same x."""
    import jax.numpy as jnp

    n, window, passes = 120, 3, 3
    chunks = _walks(np.random.default_rng(9), 3, 48, 10, n)
    jr = jco._run_sweep(lambda: ((jnp.asarray(c), 0) for c in chunks),
                        passes, n, window)
    tr = tco._run_sweep(lambda: ((torch.from_numpy(c), 0) for c in chunks),
                        passes, n, window)
    x = np.random.default_rng(1).standard_normal((n, 24)).astype(np.float32)
    steps = jalg._rsvd_step_jits()
    parts = list(jco.ppmi_ranges(jr, n))
    chunk = max(int(p[0].shape[0]) for p in parts)
    want = steps["apply"](parts[0], jnp.asarray(x), n_rows=n,
                          chunk_edges=chunk)
    for p in parts[1:]:
        want = steps["apply_add"](p, jnp.asarray(x), want, n_rows=n,
                                  chunk_edges=chunk)
    pieces = tco.ppmi_csrs(list(tr), n)
    assert all(p.row_plan() is not None for p in pieces)
    got = _apply_pieces(pieces, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_row_plan_lists_the_non_empty_rows():
    """The ascending non-empty rows of a CSR whose rows' columns ascend,
    None when some row's do not; shared by ``with_vals``."""
    indptr = torch.tensor([0, 2, 2, 5, 5, 6], dtype=torch.int64)
    cols = torch.tensor([1, 3, 0, 2, 4, 1], dtype=torch.int32)
    csr = CsrMatrix(indptr, cols, torch.ones(6))
    assert torch.equal(csr.row_plan().rows,
                       torch.tensor([0, 2, 4], dtype=torch.int32))
    assert csr.with_vals(torch.zeros(6)).row_plan() is csr.row_plan()
    bad = CsrMatrix(indptr, torch.tensor([1, 3, 2, 0, 4, 1],
                                         dtype=torch.int32), torch.ones(6))
    assert bad.row_plan() is None
    assert kernels.columns_ascend(indptr, cols)
    assert not kernels.columns_ascend(bad.indptr, bad.indices)


def _walk_slices(plan, indptr, cols, band_rows, x_rows):
    """The entries K5's long-row kernel visits, row by row and slice by
    slice, band by band (its loops in Python): the number of visits of each
    entry."""
    seen = torch.zeros(cols.shape[0], dtype=torch.int64)
    bands = -(-x_rows // band_rows)
    work = ([(r, 1, int(indptr[r])) for r in plan.whole.tolist()]
            + list(zip(plan.item_rows.tolist(), plan.item_cuts.tolist(),
                       plan.item_starts.tolist())))
    cursor = [e0 for _, _, e0 in work]
    for band in range(bands):
        hi, last = (band + 1) * band_rows, band == bands - 1
        for w, (row, cuts, e0) in enumerate(work):
            end, e = int(indptr[row + 1]), cursor[w]
            while e < end:
                cs = e0 + (e - e0) // 32 * 32 if cuts > 1 else e
                ce = min(cs + 32, end)
                k = sum(1 for i in range(e, ce) if last or cols[i] < hi)
                seen[e:e + k] += 1
                e += k
                if cuts == 1:
                    if k < 32:
                        break
                elif e < ce:
                    break
                else:
                    e = cs + 32 * cuts
            cursor[w] = e
    return seen


@pytest.mark.parametrize("cut", [32, 64, 4096])
def test_row_plan_cuts_long_rows_into_slices(monkeypatch, cut):
    """K5's long-row kernel gives each whole row and each slice a warp: a
    row of L > LONG_SLICE entries becomes K = ceil(L / LONG_SLICE) adjacent
    slices (at most one a chunk of 32 entries), slice j starting at the
    row's chunk j and taking every K-th chunk; ``split`` lists the first
    slice of each cut row.  The kernel's walk over rows, slices and bands
    visits every entry once."""
    monkeypatch.setattr(kernels, "LONG_SLICE", cut)
    lengths = np.array([40, 0, 100, 3, 0, 70, 1])
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]))
    rng = np.random.default_rng(5)
    cols = torch.from_numpy(np.concatenate(
        [np.sort(rng.integers(0, 50, size=k)) for k in lengths]).astype(
            np.int32))
    plan = kernels.row_plan(indptr, cols)
    assert plan.rows.tolist() == [0, 2, 3, 5, 6]
    want = {32: ([3, 6], [0, 0, 2, 2, 2, 2, 5, 5, 5],
                 [0, 32, 40, 72, 104, 136, 143, 175, 207],
                 [2, 2, 4, 4, 4, 4, 3, 3, 3], [0, 2, 6]),
            64: ([0, 3, 6], [2, 2, 5, 5], [40, 72, 143, 175], [2, 2, 2, 2],
                 [0, 2]),
            4096: ([0, 2, 3, 5, 6], [], [], [], [])}[cut]
    assert plan.whole.tolist() == want[0]
    assert plan.item_rows.tolist() == want[1]
    assert plan.item_starts.tolist() == want[2]
    assert plan.item_cuts.tolist() == want[3]
    assert plan.split.tolist() == want[4]
    assert plan.item_starts.dtype == torch.int64
    assert all(t.dtype == torch.int32 for t in (
        plan.rows, plan.whole, plan.item_rows, plan.item_cuts, plan.split))
    for band_rows in (7, 20, 50):
        assert torch.all(_walk_slices(plan, indptr, cols, band_rows, 50) == 1)


def test_merge_and_row_plan_wrappers_check_their_arguments():
    """Checked before any device is touched: int32 ranges of one length
    each; a row plan needs acc, b == 0 and no z."""
    z = torch.zeros(4, dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="1-D int32"):
        kernels.run_length_merge((z, z, z.long()), (z, z, z))
    with pytest.raises(ValueError, match="differ in length"):
        kernels.run_length_merge((z, z, z[:3]), (z, z, z))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.run_length_merge((z, z, z), (z, z, z))
    indptr = torch.arange(5, dtype=torch.int64)
    x = torch.zeros((4, 8))
    rows = kernels.row_plan(indptr, z)
    with pytest.raises(ValueError, match="rows needs acc"):
        kernels.spmm_axpy(indptr, z, torch.ones(4), x, 1.0, rows=rows)
    with pytest.raises(ValueError, match="rows needs acc"):
        kernels.spmm_axpy(indptr, z, torch.ones(4), x, 1.0, b=1.0,
                          acc=torch.zeros((4, 8)), d=1.0, rows=rows)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
