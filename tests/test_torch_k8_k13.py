"""K8's record form and K13's lane layout on the CPU.

K8 reads a row's start and degree from one 8-byte record
(``kernels.walk_record``, ``WalkTables.record``); K13 reads its tables in
the layout ``kernels.pq_lane_tables`` makes, 16, 8 or 4 queries side by
side and 32/width subspaces a 32-word line.  The kernels themselves run
only on the card (``tests/test_torch_kernels.py``); here the record and
the layout are held to the arrays they come from, the tables' walks to
the three-array walks and the CSR's edges, the tile width to the queries
and shared memory, the packed loads' schedule to the m order and the
banks, and the layout's reads, restated in the kernel's indexing, to the
plain version and to the JAX package's scores.

Tolerances: bitwise, but for the JAX package's PQ scores (atol=1e-5: its
tables come from its own einsum, the port's from torch's, on the same
queries and codebooks).
"""

import numpy as np
import pytest
import torch

import cleora_tpu.algorithms as jalg
import cleora_tpu.compress as jcp
import cleora_tpu_torch.compress as tcp
from cleora_tpu_torch import kernels
from cleora_tpu_torch.ops import walk as twalk
from cleora_tpu_torch.ops.pq import pq_adc, pq_adc_plain
from torch_test_support import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def walk_csr(n, seed):
    """A walk CSR with dead ends (every 7th node has degree 0) and one hub."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(3, size=n)
    deg[::7] = 0
    deg[1] = 200
    indptr = np.concatenate([[0], np.cumsum(deg)[:-1]])
    cols = rng.integers(0, n, size=int(deg.sum()))
    return indptr, cols, deg


# ------------------------------------------------------------------ K8
def test_walk_record_is_indptr_and_deg_bitwise():
    indptr, cols, deg = walk_csr(500, 1)
    t = twalk.WalkTables(indptr, cols, deg, 500, CPU)
    rec = kernels.walk_record(t.indptr, t.deg)
    assert rec.dtype == torch.int32 and rec.shape == (500, 2)
    assert rec.is_contiguous() and rec.stride() == (2, 1)
    assert torch.equal(rec[:, 0], t.indptr) and torch.equal(rec[:, 1], t.deg)
    assert torch.equal(t.record, rec)
    # int64 inputs are narrowed, as the tables hold them
    assert torch.equal(kernels.walk_record(t.indptr.long(), t.deg.long()),
                       rec)


def test_walk_record_over_the_jax_walk_csr():
    """The record of the JAX package's walk CSR of a graph is its
    (indptr, deg), row by row."""
    import cleora_tpu as ct

    rng = np.random.default_rng(11)
    lines = [f"n{rng.integers(0, 150)} n{rng.integers(0, 150)}"
             for _ in range(900)]
    ref = ct.SparseMatrix.from_iterator(iter(lines), "complex::reflexive::n")
    indptr, cols, deg, n = jalg._walk_csr(ref)
    t = twalk.WalkTables(indptr, cols, deg, n, CPU)
    assert np.array_equal(t.record.numpy(),
                          np.stack([indptr, deg], 1).astype(np.int32))


@pytest.mark.parametrize("length", [1, 7, 8, 9, 17, 80])
@pytest.mark.parametrize("seed,base", [(0, 0), (2**40 + 3, 2**33 + 5)])
def test_walks_over_the_tables_are_the_plain_walks_along_edges(length,
                                                               seed, base):
    """The tables' walks (what K8 is held to on the card) on the CPU: the
    plain walks over the three arrays, every move an edge of the CSR, the
    sentinel after a dead end or a pad lane, and dead ends reached within
    a store group of K8."""
    n = 400
    indptr, cols, deg = walk_csr(n, 2)
    t = twalk.WalkTables(indptr, cols, deg, n, CPU)
    rng = np.random.default_rng(3)
    starts = rng.integers(0, n, size=300).astype(np.int32)
    starts[::10] = n        # pad lanes
    starts[5::10] = 0       # a dead end at the start
    starts = torch.from_numpy(starts)
    w = twalk.walk_uniform(t, starts, length, seed, base)
    assert torch.equal(w, twalk.walk_uniform_plain(
        t.indptr, t.cols, t.deg, starts, length, seed, base, n))
    w = w.numpy()
    edges = {(i, int(j)) for i in range(n)
             for j in cols[indptr[i]:indptr[i] + deg[i]]}
    for a_, b_ in zip(w[:, :-1].reshape(-1), w[:, 1:].reshape(-1)):
        if a_ == n or deg[a_] == 0:
            assert b_ == n
        else:
            assert (int(a_), int(b_)) in edges
    if length >= 9:
        # dead ends reached mid-group: a walk turns to the sentinel after
        # its first hop and before its last, at a hop not a multiple of 8
        hit = (w[:, 1:] == n) & (w[:, :-1] < n)
        steps = np.nonzero(hit)[1] + 1
        assert steps.size and np.any(steps % 8 != 0)


def test_device_walks_pass_the_tables():
    n = 300
    indptr, cols, deg = walk_csr(n, 4)
    t = twalk.WalkTables(indptr, cols, deg, n, CPU)
    seen = []
    real = twalk.walk_uniform

    def spy(*args):
        seen.append(args[0])
        return real(*args)

    twalk.walk_uniform = spy
    try:
        got = list(twalk.device_walks(t, np.nonzero(deg)[0].astype(np.int32),
                                      2, 9, 5, batch=128))
    finally:
        twalk.walk_uniform = real
    assert seen and all(s is t for s in seen)
    assert sum(w.shape[0] for w in got) == 2 * int(np.count_nonzero(deg))


# ------------------------------------------------------------------ K13
def tables_from_lanes(lanes, q, m):
    """The (Q, M, C) tables that ``kernels.pq_lane_tables`` laid out as
    ``lanes``."""
    t, p, c, g, qt = lanes.shape
    flat = lanes.permute(0, 4, 1, 3, 2).reshape(t * qt, p * g, c)
    return flat[:q, :m]


def lane_reads(lanes, codes, q, m):
    """K13's scores restated in its indexing: with tiles of W queries and
    S = 32/W subspaces a line, the word of (query, m, code) in the flat
    lane tables is tile·T + ((m // S)·C + code)·32 + (m % S)·W + query % W,
    T = ceil(M/S)·C·32 and tile = query // W; added in m order from -0.0,
    as the kernel adds."""
    t, lines, c, g, qt = lanes.shape
    flat = lanes.reshape(-1)
    tile_words = lines * c * g * qt
    query = torch.arange(q)[:, None]
    codes = codes.long()
    sums = torch.full((q, codes.shape[0]), -0.0)
    for mm in range(m):
        word = ((query // qt) * tile_words
                + ((mm // g) * c + codes[:, mm][None, :]) * (g * qt)
                + (mm % g) * qt + query % qt)
        sums = sums + flat[word]
    return sums


def packed_schedule(width: int, lag: int):
    """``pq_adc.cu`` run_packed's loads for the row of lag ``lag`` in tiles
    of ``width`` queries: a list, one entry a load, of (row step, subspace)
    or None where the load adds nothing."""
    steps, m, s = 4, 8, 32 // width
    out = []
    for t in range(steps * m + s - 1):
        r, ka = t % m, t // m
        now = r >= lag
        k = ka if now else ka - 1
        out.append((k, (r + m - lag) % m) if 0 <= k < steps else None)
    return out


@pytest.mark.parametrize("q,m,c,want", [
    (1, 8, 256, 4), (4, 8, 256, 4), (5, 8, 256, 8), (8, 8, 256, 8),
    (9, 8, 256, 16), (1024, 8, 256, 16), (1024, 16, 256, 8),
    (64, 32, 256, 4), (1024, 64, 1024, 4)])
def test_tile_width_holds_the_queries_and_fits_shared_memory(q, m, c, want):
    width = kernels.pq_tile_width(q, m, c)
    assert width == want
    lines = -(-m // (32 // width))
    fits = lines * c * 128 <= 227 * 1024
    assert fits or width == 4  # else read from global memory
    if width < 16 and q > width:
        # narrowed: the next wider tile does not fit
        assert -(-m // (16 // width)) * c * 128 > 227 * 1024


@pytest.mark.parametrize("q,m,c", [(1, 8, 256), (16, 8, 256), (17, 8, 256),
                                   (33, 1, 7), (37, 3, 40), (64, 4, 300),
                                   (5, 2, 1)])
@pytest.mark.parametrize("width", [4, 8, 16])
def test_lane_tables_round_trip_and_their_reads_are_the_plain_scores(
        q, m, c, width):
    gen = torch.Generator().manual_seed(q * 100 + m)
    tables = torch.randn((q, m, c), generator=gen)
    tables[0, 0, 0] = -0.0  # a first term of -0.0 stays -0.0
    n = 301
    lanes = kernels.pq_lane_tables(tables, width)
    s = 32 // width
    tiles, lines = -(-q // width), -(-m // s)
    assert lanes.shape == (tiles, lines, c, s, width)
    assert lanes.dtype == torch.float32 and lanes.is_contiguous()
    back = tables_from_lanes(lanes, q, m)
    assert torch.equal(back, tables)
    assert torch.equal(back.view(torch.int32), tables.view(torch.int32))
    # the empty slots and the padding past M are zero and never read
    full = lanes.permute(0, 4, 1, 3, 2).reshape(tiles * width, lines * s, c)
    assert not full[q:].any() and not full[:, m:].any()
    codes = torch.randint(0, c, (n, m), generator=gen, dtype=torch.int32)
    codes[0] = 0
    want = pq_adc_plain(tables, codes)
    assert torch.equal(pq_adc_plain(back, codes), want)
    got = lane_reads(lanes, codes, q, m)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("width", [4, 8, 16])
def test_packed_loads_add_each_row_in_m_order_free_of_bank_conflicts(width):
    """Every row of a quarter-warp (lags 0 .. S-1) adds its 4 rows' 8
    subspaces once each, in m order, and at each load the rows that add
    read S different parts of a 128-byte line (subspace m % S)."""
    s = 32 // width
    plans = [packed_schedule(width, lag) for lag in range(s)]
    for plan in plans:
        assert [x for x in plan if x] == [(k, mm) for k in range(4)
                                          for mm in range(8)]
    for loads in zip(*plans):
        parts = [mm % s for x in loads if x for mm in [x[1]]]
        assert len(parts) == len(set(parts))
    # the lag costs S - 1 loads a run
    assert len(plans[0]) == 32 + s - 1


@pytest.mark.parametrize("lag", range(8))
def test_packed_code_rotation_gives_each_loads_code(lag):
    """A row's code word (``pq_adc.cu`` run_packed) rotated by ``lag``
    codes: its byte r is the code of subspace r - lag (mod 8), the
    subspace the row of that lag reads at the load where a row of lag 0
    reads subspace r."""
    rng = np.random.default_rng(lag)
    codes = rng.integers(0, 256, size=(50, 8), dtype=np.uint64)
    word = np.zeros(50, np.uint64)
    for i in range(8):
        word |= codes[:, i] << np.uint64(8 * i)
    rotated = word if lag == 0 else (
        (word << np.uint64(8 * lag)) | (word >> np.uint64(64 - 8 * lag)))
    for r in range(8):
        got = (rotated >> np.uint64(8 * r)) & np.uint64(0xff)
        assert np.array_equal(got, codes[:, (r - lag) % 8])


@pytest.mark.parametrize("n,k", [(1, 1), (31, 31), (32, 5), (33, 33),
                                 (301, 10)])
def test_top_k_over_rows_padded_with_minus_inf_is_the_plain_top_k(n, k):
    """``ops.pq.pq_topk`` takes the top k of K13's rows padded to a
    multiple of 32 floats with -inf; restated here on the plain scores:
    the padding is never taken and the result is the plain top k."""
    from cleora_tpu_torch.ops.pq import pq_topk

    gen = torch.Generator().manual_seed(n)
    tables = torch.randn((7, 3, 16), generator=gen)
    codes = torch.randint(0, 16, (n, 3), generator=gen, dtype=torch.int32)
    plain = pq_adc_plain(tables, codes)
    rows = torch.full((7, -(-n // 32) * 32), float("-inf"))
    rows[:, :n] = plain
    got = torch.topk(rows, k, dim=1)
    want = pq_topk(tables, codes, k)
    assert torch.equal(got.values, want.values)
    assert bool((got.indices < n).all())
    assert torch.equal(torch.gather(plain, 1, got.indices), got.values)
    assert torch.equal(want.values, torch.topk(plain, k, dim=1).values)


def test_lane_reads_match_the_jax_scores():
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((700, 32)).astype(np.float32)
    ours = tcp.product_quantize(emb, num_subspaces=8, num_centroids=32,
                                max_iter=5, seed=1, device="cpu")
    theirs = jcp.PQIndex(ours._codes, ours._codebooks, 8, 4, emb.shape)
    queries = emb[rng.choice(700, 19, replace=False)]
    full = theirs.search_batch(queries, top_k=700, backend="device")
    want = np.empty((19, 700), np.float32)
    np.put_along_axis(want, full["indices"], full["scores"], axis=1)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    tables = torch.einsum(
        "qmd,mcd->qmc", torch.from_numpy(qn.reshape(19, 8, 4)),
        torch.from_numpy(ours._normalized_codebooks().astype(np.float32)))
    codes = torch.from_numpy(ours._codes)
    width = kernels.pq_tile_width(19, 8, 32)
    got = lane_reads(kernels.pq_lane_tables(tables, width), codes, 19, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got, pq_adc(tables, codes))
