"""The blocked GraRep's band-major panel on the CPU: the band-width rule,
the layout's round trip, the plain versions of K1's and K7's band forms
bitwise the row-major plain versions, the port's blocked GraRep against the
JAX package's, and the one-rank sharded block's walk bitwise the one-card
block's.  The kernels themselves are held to K1 and K7 on the card
(``tests/test_torch_kernels.py``, marker ``cuda``).

Tolerances: the plain band forms do the same float32 operations on the
same elements in the same order as the row-major plain versions, so they
are compared bitwise; the blocked GraRep against the JAX package's at
``test_torch_algorithms.py::test_blocked_matches_dense``'s aligned error,
1e-3 up to per-column signs, with a sketch of width ≥ n so both
randomized SVDs span the full range (about 5 s alone, most of it the JAX
package's compiles).
"""

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu.algorithms as jalg
import cleora_tpu_torch.algorithms as talg
from cleora_tpu_torch import kernels
from cleora_tpu_torch.convert import from_jax_state
from cleora_tpu_torch.ops.dense import (
    log_clip_bands_plain,
    log_clip_plain,
)
from cleora_tpu_torch.ops.spmm import (
    CsrMatrix,
    from_bands,
    one_hot_bands,
    panel_band,
    spmm_bands_plain,
    spmm_plain,
    to_bands,
)
from cleora_tpu_torch.parallel import algorithms as palg
from torch_test_support import one_torch_thread  # noqa: F401

G = kernels.BAND_COLUMNS


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 300, 900), rng.integers(0, 300, 900)
    ref = ct.SparseMatrix.from_edge_arrays(src, dst)
    return ref, from_jax_state(ref.__getstate__())


def _aligned_err(a, b):
    """Largest difference up to per-column sign flips."""
    assert a.shape == b.shape
    sign = np.sign(np.sum(a * b, axis=0))
    sign[sign == 0] = 1.0
    return np.abs(a - b * sign).max()


def _csr(n, seed, n_cols=None):
    """A CSR with an empty row, a row of 40 entries and random values."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, size=n)
    deg[3] = 0
    deg[5] = 40
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n_cols or n, size=int(indptr[-1]))
    vals = rng.random(cols.shape[0]).astype(np.float32)
    return CsrMatrix(torch.from_numpy(indptr),
                     torch.from_numpy(cols.astype(np.int32)),
                     torch.from_numpy(vals))


@pytest.mark.parametrize("width, all_gather, want", [
    (4096, True, G),      # GraRep's panel at 200,000 rows on the card
    (1152, True, G),      # its width at 1.96 M rows on an 80 GB card
    (2432, True, G),      # and at 1 M rows
    (70, True, G),        # a ragged last band
    (4096, False, 4096),  # a halo plan: the row-major panel
    (70, False, 70),
])
def test_band_width_rule(width, all_gather, want):
    assert panel_band(width, all_gather) == want


def test_band_layout_round_trip_with_a_ragged_band():
    x = torch.randn((50, 70))
    y = to_bands(x, G)
    assert y.shape == (3, 50, G) and y.is_contiguous()
    assert torch.equal(y[2, :, 70 - 2 * G:], torch.zeros((50, 3 * G - 70)))
    assert torch.equal(y[1], x[:, G:2 * G])
    back = from_bands(y, 70)
    assert torch.equal(back, x) and back.is_contiguous()
    # one band of the whole width is the row-major panel, copied out
    one = x[None].clone()
    out = from_bands(one, 70)
    assert torch.equal(out, x) and out.data_ptr() != one.data_ptr()


def test_one_hot_bands_is_the_one_hot_block():
    n, b = 300, 70
    for start in (0, 280):  # the last block's tail columns stay 0
        want = torch.zeros((n, b))
        for j in range(min(b, n - start)):
            want[start + j, j] = 1.0
        assert torch.equal(from_bands(one_hot_bands(n, b, G, start, "cpu"),
                                      b), want)
        assert torch.equal(talg._one_hot_block(n, b, start, "cpu"), want)
        # a shard's rows [100, 200) of the same seed
        part = one_hot_bands(100, b, G, start, "cpu", base=100, n=n)
        assert torch.equal(from_bands(part, b), want[100:200])


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("b", [70, 96])
def test_spmm_bands_plain_is_bitwise_the_row_major_plain(parts, b):
    """Over one card's panel and over ``parts`` parts of an all-gathered
    table (column c at part c // rps, row c % rps)."""
    rps = 40
    csr = _csr(60, b, n_cols=parts * rps)
    x = torch.randn((parts * rps, b))
    table = torch.cat([to_bands(x[p * rps:(p + 1) * rps], G)
                       for p in range(parts)])
    got = spmm_bands_plain(csr, table, parts)
    assert got.shape == (-(-b // G), 60, G)
    assert torch.equal(got, to_bands(spmm_plain(csr, x), G))


@pytest.mark.parametrize("scaled", [False, True])
def test_log_clip_bands_plain_is_bitwise_log_clip_plain(scaled):
    n, b = 50, 70
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((n, b), generator=gen) * 4
    x[x < 1.0] = 0.0
    r = torch.rand(n, generator=gen) + 0.5 if scaled else None
    c = torch.rand(b, generator=gen) + 0.5 if scaled else None
    y = to_bands(x, G)
    kept = y.clone()
    floor, offset = talg._GRAREP_FLOOR, talg._GRAREP_OFFSET
    got = log_clip_bands_plain(y, r, c, floor, offset, b)
    assert torch.equal(got, log_clip_plain(x.clone(), r, c, floor, offset))
    assert torch.equal(y, kept)


def _record(monkeypatch, module, name):
    """Calls of ``module.name`` recorded: a list of (args, result)."""
    calls, real = [], getattr(module, name)

    def call(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, call)
    return calls


def test_blocked_grarep_matches_the_jax_packages(graphs, monkeypatch):
    ref, g = graphs
    n = g.num_entities
    # a sketch of width n spans the whole range with no power iteration
    # (each costs the JAX package seconds of compiling here)
    kw = dict(feature_dim=16, max_step=2, backend="device", block_rows=70,
              oversample=n, power_iters=0)
    clips = _record(monkeypatch, talg, "log_clip_bands")
    got = talg.embed_grarep(g, device="cpu", **kw)
    # the walk ran band-major: 70 columns in three bands of 32
    assert clips and all(args[0].shape == (3, n, G) for args, _ in clips)
    want = jalg.embed_grarep(ref, **kw)
    assert got.dtype == np.float32
    assert _aligned_err(got, want) <= 1e-3


def test_one_rank_sharded_block_walk_is_bitwise_the_one_card_walk(
        graphs, monkeypatch):
    """Every block's seed, its ``max_step`` powers and each power's L, in
    the order the sweeps make them: the one-rank sharded path (its shard
    padded past n with rows that stay 0) against the one-card path on the
    same graph and seed."""
    _, g = graphs
    n = g.num_entities
    kw = dict(feature_dim=16, max_step=2, backend="device", device="cpu",
              block_rows=70, power_iters=1, seed=3)
    walks = {}
    for label, module, extra in (("card", talg, {}),
                                 ("sharded", palg, {"n_devices": 1})):
        calls = [_record(monkeypatch, module, name) for name in
                 ("one_hot_bands", "spmm_bands", "log_clip_bands")]
        talg.embed_grarep(g, **kw, **extra)
        walks[label] = [[out for _, out in c] for c in calls]
        monkeypatch.undo()
    (seeds, steps, clips), (sseeds, ssteps, sclips) = (walks["card"],
                                                       walks["sharded"])
    blocks, sweeps = -(-n // 70), 2 + 2 * 1
    assert len(seeds) == len(sseeds) == blocks * sweeps
    assert len(steps) == len(clips) == 2 * blocks * sweeps
    assert len(ssteps) == len(sclips) == len(steps)
    for a, b in zip(seeds + steps, sseeds + ssteps):
        assert a.shape == (3, n, G) and torch.equal(a, b[:, :n])
        assert not b[:, n:].any()
    for a, b in zip(clips, sclips):
        assert a.shape == (n, 70) and torch.equal(a, b[:n])
