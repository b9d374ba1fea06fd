"""K19's round modes and K11's two passes on the CPU.

* K19 (``ops.spmm.spmm_acc_plain`` through ``parallel.embed.overlap_views``
  and ``overlap_round``, as ``OverlapExchange`` runs a step): round 0
  writes a view of every row, middle rounds add their compact rows, the
  last round adds a view of every row, mixes the residual and normalises.
  Bitwise the chain it replaced: a zero accumulator, the previous plain
  version's index_add_ per compact round, the torch residual mix, then
  ``normalize_plain``.  Cases: rows with no edge, an empty round, a row
  over ``kernels.LONG_SLICE`` entries, bf16 tables, D = 7 and 1,028.
* K11 (``ops.cooccur.ppmi_rows_plain`` then ``ppmi_vals_plain``): each
  pass bitwise the previous single plain version's outputs (the same
  int64 sums and float32 operations in the same order), on an empty
  range, rows of one entry, rows at node 0 and node n - 1, gaps of empty
  rows and a row over ``LONG_SLICE`` entries; the whole CPU transform
  against ``cleora_tpu.ops.cooccur.ppmi_ranges`` (rtol=1e-6: float32 row
  sums that are exact here, another ``log``); decreasing or out-of-range
  ids raise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cleora_tpu.ops import cooccur as jco

from cleora_tpu_torch import kernels
from cleora_tpu_torch.ops import cooccur as tco
from cleora_tpu_torch.ops.normalize import normalize_plain
from cleora_tpu_torch.ops.spmm import spmm_acc, spmm_acc_plain
from cleora_tpu_torch.parallel.embed import overlap_round, overlap_views
from cleora_tpu_torch.parallel.shard import RoundCsr

RPS = 60  # rows of the shard
M = 50  # rows of a received slab
HUB = kernels.LONG_SLICE + 37


# ------------------------------------------------------------------ K19
def old_round(acc, row_ids, indptr, cols, vals, table):
    """The previous plain version of K19: the round's per-row sums by
    gather, scale and index_add_, then one index_add_ into acc."""
    n = row_ids.shape[0]
    seg = torch.repeat_interleave(torch.arange(n), indptr[1:] - indptr[:-1])
    sums = torch.zeros((n, acc.shape[1]))
    scaled = table.index_select(0, cols.long()).float() * vals[:, None]
    sums.index_add_(0, seg, scaled)
    return acc.index_add_(0, row_ids.long(), sums)


def make_rounds(rng, n_rounds):
    """A shard's rounds as RoundCsr: rows with no edge in any round, row 5
    over LONG_SLICE entries in round 0 and in the last round; round 1 is
    empty where it is a middle round."""
    rounds = []
    for r in range(n_rounds):
        if r == 1 and n_rounds > 2:
            rounds.append(RoundCsr.from_edges(np.zeros(0, np.int32),
                                              np.zeros(0, np.int32),
                                              np.zeros(0, np.float32)))
            continue
        rows = np.sort(rng.choice(np.arange(6, RPS - 3), 20, replace=False))
        deg = rng.integers(1, 6, size=rows.shape[0])
        lrows = np.repeat(rows, deg)
        if r in (0, n_rounds - 1):
            lrows = np.sort(np.concatenate([lrows, np.full(HUB, 5)]))
        n_table = RPS if r == 0 else M
        cols = rng.integers(0, n_table, size=lrows.shape[0])
        vals = rng.random(lrows.shape[0]).astype(np.float32)
        rounds.append(RoundCsr.from_edges(lrows.astype(np.int32), cols,
                                          vals))
    return rounds


@pytest.mark.parametrize("d", [7, 1028])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rounds,w,norm", [(1, 0.3, "l2"), (4, 0.0, "l1"),
                                             (3, 0.3, "l2"),
                                             (2, 0.5, "none")])
def test_k19_modes_are_the_old_chain(d, dtype, n_rounds, w, norm):
    rng = np.random.default_rng(d + n_rounds)
    rounds = make_rounds(rng, n_rounds)
    x = torch.from_numpy(rng.standard_normal((RPS, d)).astype(np.float32)
                         ).to(dtype)
    tables = [x] + [torch.from_numpy(rng.standard_normal((M, d)).astype(
        np.float32)).to(dtype) for _ in range(1, n_rounds)]
    want = torch.zeros((RPS, d))
    for rc, table in zip(rounds, tables):
        old_round(want, *(torch.from_numpy(a) for a in (
            rc.row_ids, rc.indptr, rc.cols, rc.vals)), table)
    if w > 0.0:
        want = (1.0 - w) * want + w * x.float()
    want = normalize_plain(want, norm)
    views = overlap_views(rounds, RPS, torch.device("cpu"))
    assert [v[0] is None for v in views] == [
        r in (0, n_rounds - 1) for r in range(n_rounds)]
    assert all(v[4] is None for v in views)  # hub plans only on CUDA
    got = torch.full((RPS, d), float("nan"))  # round 0 writes every row
    for r, table in enumerate(tables):
        assert overlap_round(got, views, r, table, x, w, norm) is got
    assert torch.equal(got, want)


def test_k19_one_round_is_spmm_acc_plain_over_every_row():
    """One shard: the single round's view of every row, written, mixed
    and normalised, is the plain version called with those modes."""
    rng = np.random.default_rng(4)
    (rc,) = make_rounds(rng, 1)
    x = torch.from_numpy(rng.standard_normal((RPS, 16)).astype(np.float32))
    (view,) = overlap_views([rc], RPS, torch.device("cpu"))
    row_ids, indptr, cols, vals, _ = view
    assert indptr.shape == (RPS + 1,)
    assert torch.equal(torch.diff(indptr)[torch.from_numpy(rc.row_ids).long()],
                       torch.from_numpy(np.diff(rc.indptr)))
    want = spmm_acc_plain(torch.zeros((RPS, 16)), None, indptr, cols, vals,
                          x, True, 0.2, x, "l1")
    got = spmm_acc(torch.empty((RPS, 16)), None, indptr, cols, vals, x,
                   write=True, residual_weight=0.2, residual=x,
                   normalization="l1")
    assert torch.equal(got, want)


def test_k19_modes_need_a_view_of_every_row():
    rng = np.random.default_rng(5)
    rc = make_rounds(rng, 3)[2]
    args = [torch.from_numpy(a) for a in (rc.row_ids, rc.indptr, rc.cols,
                                          rc.vals)]
    acc, table = torch.zeros((RPS, 4)), torch.zeros((M, 4))
    for kw in (dict(write=True), dict(normalization="l2"),
               dict(residual_weight=0.5, residual=acc)):
        with pytest.raises(ValueError, match="need a view of every row"):
            spmm_acc(acc, *args, table, **kw)
    with pytest.raises(ValueError, match="must list every row of acc"):
        spmm_acc(acc, None, *args[1:], table)
    with pytest.raises(ValueError, match="unknown normalization"):
        spmm_acc(acc, *args, table, normalization="spectral")


# ------------------------------------------------------------------ K11
N = 6000


def ppmi_case(name):
    """(cen, ctx, cnt) of one (cen, ctx)-sorted range of N nodes."""
    rng = np.random.default_rng(len(name))
    if name == "empty":
        rows, lengths = np.zeros(0, np.int64), np.zeros(0, np.int64)
    elif name == "one_entry_rows":
        rows = np.sort(rng.choice(N, 300, replace=False))
        lengths = np.ones(300, np.int64)
    elif name == "first_and_last_node":
        rows, lengths = np.array([0, 17, N - 1]), np.array([3, 9, 4])
    elif name == "gaps":
        rows = np.cumsum(rng.integers(1, 200, size=40))
        lengths = rng.integers(1, 30, size=40)
    else:  # a row over LONG_SLICE entries between short ones
        rows = np.array([2, 3, 900, 4000])
        lengths = np.array([5, kernels.LONG_SLICE + 100, 1, 12])
    cen = np.repeat(rows, lengths)
    ctx = np.concatenate([np.sort(rng.choice(N, k, replace=False))
                          for k in lengths]) if len(rows) else rows
    cnt = rng.integers(1, 50, size=cen.shape[0])
    return tuple(torch.from_numpy(a.astype(np.int32)) for a in (cen, ctx, cnt))


CASES = ["empty", "one_entry_rows", "first_and_last_node", "gaps", "hub"]


def old_ppmi_values_plain(cen, ctx, cnt, col, total, n):
    """The previous single plain version of K11."""
    c64 = cen.long()
    rows = torch.zeros((n,), dtype=torch.int64)
    rows.index_add_(0, c64, cnt.long())
    rs = torch.clamp_min(rows[c64].to(torch.float32), 1e-10)
    cs = torch.clamp_min(col[ctx.long()].to(torch.float32), 1e-10)
    q = cnt.to(torch.float32) * total.to(torch.float32) / (rs * cs)
    vals = torch.clamp_min(torch.log(torch.clamp_min(q, 1e-15)), 0.0)
    indptr = torch.zeros((n + 1,), dtype=torch.int64)
    torch.cumsum(torch.bincount(c64, minlength=n), 0, out=indptr[1:])
    return vals, indptr, rows


@pytest.mark.parametrize("case", CASES)
def test_k11_passes_are_the_old_plain_version(case):
    cen, ctx, cnt = ppmi_case(case)
    col, total = tco.range_col_sums([(cen, ctx, cnt, cen.shape[0])], N,
                                    torch.device("cpu"))
    col[::3] += 7  # contexts counted in other ranges
    total += 1000
    want_vals, want_indptr, want_rs = old_ppmi_values_plain(
        cen, ctx, cnt, col, total, N)
    indptr, rs = tco.ppmi_rows_plain(cen, cnt, N)
    assert torch.equal(indptr, want_indptr) and torch.equal(rs, want_rs)
    vals = tco.ppmi_vals_plain(cen, ctx, cnt, col, total, rs)
    assert vals.dtype == torch.float32 and torch.equal(vals, want_vals)
    got = tco.ppmi_values(cen, ctx, cnt, col, total, N)
    assert torch.equal(got[0], want_vals) and torch.equal(got[1], want_indptr)


@pytest.mark.parametrize("case", CASES[1:])
def test_k11_cases_equal_the_jax_ones(case):
    cen, ctx, cnt = ppmi_case(case)
    m = cen.shape[0]
    want = jco.ppmi_ranges([tuple(jnp.asarray(t.numpy()) for t in
                                  (cen, ctx, cnt)) + (m,)], N)[0]
    rows, cols, vals = tco.ppmi_ranges([(cen, ctx, cnt, m)], N)[0]
    assert np.array_equal(np.asarray(want[0]), rows.numpy())
    assert np.array_equal(np.asarray(want[1]), cols.numpy())
    np.testing.assert_allclose(vals.numpy(), np.asarray(want[2]), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("fault", ["decreasing", "cen_past_n", "negative_ctx"])
def test_k11_rejects_unsorted_or_out_of_range_ids(fault):
    cen, ctx, cnt = ppmi_case("gaps")
    if fault == "decreasing":
        cen = cen.flip(0).contiguous()
    elif fault == "cen_past_n":
        cen = cen.clone()
        cen[-1] = N
    else:
        ctx = ctx.clone()
        ctx[3] = -1
    col = torch.ones((N,), dtype=torch.int64)
    total = torch.tensor([100], dtype=torch.int64)
    with pytest.raises(ValueError, match="cen must be non-decreasing"):
        tco.ppmi_values(cen, ctx, cnt, col, total, N)
