"""K6 written once from shared tiles and K4 over the raw state.

On the CPU: K6's plain version against the JAX package's ``_dense_markov``;
K4's new contract (``edge_attention_weights_plain(csr, x, T)`` normalises
``x`` itself) bitwise the old arithmetic on ``l2_normalize_plain(x)`` and
against ``tests/test_torch_modes.py``'s numpy restatement of the JAX step;
``embed_with_attention`` past 1,024 columns (the path K4 serves on the
card) against the JAX package's.  On the card (marker ``cuda``): K6 at
several n with duplicate entries, an all-duplicate row, an empty row and a
hub, its deg bitwise the first design's summation order (restated in
numpy) and P bitwise ``val / deg`` on every row without duplicates; K4 at
widths 7 to 4,096 with empty rows, an all-zero-valued row and a hub of
50,000 entries, the hub in slices and a join and walked by one team; the
wide attention step's launches.  The JAX package is
imported inside the tests that use it, so the card's cases also run where
JAX is not installed (``python -m pytest --noconftest
tests/test_torch_k4_k6.py``).

Tolerances: K6's P and deg atol=1e-6, vol rtol=1e-6 (float32 row sums in
another order than the JAX package's, duplicates added in another order;
JAX sums the volume in float32); on the card deg also rtol=1e-5 against
the plain version (the 5,000-entry hub's sum, about 2,500, in two float32
orders), and bitwise the first design's order; K4's plain version against the numpy
restatement atol=1e-6 (as ``test_torch_modes.py``), the kernel against
the plain version rtol=1e-5, atol=1e-6 (dot products, norms and row sums
in another order); ``embed_with_attention`` rtol=1e-4, atol=1e-5 (as
``test_torch_modes.py``: float32 sums over a few iterations).
"""

import numpy as np
import pytest
import torch

from cleora_tpu_torch import kernels
from cleora_tpu_torch.ops.attention import (
    attention_spmm_plain,
    attention_step,
    edge_attention_weights,
    edge_attention_weights_plain,
)
from cleora_tpu_torch.ops.dense import dense_markov, dense_markov_plain
from cleora_tpu_torch.ops.normalize import l2_normalize_plain
from cleora_tpu_torch.ops.spmm import CsrMatrix
from torch_test_support import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
cuda = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# ------------------------------------------------------------------ K6


def markov_coo(n, seed, hub=0, all_dup=0):
    """Row-sorted COO of an n x n matrix: about 5 entries a row, every
    other entry of a row repeating the one before it, row n // 2 empty,
    row 0 ``all_dup`` copies of one column, row n - 1 ``hub`` entries."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(5, size=n) + 1
    deg[n // 2] = 0
    if n > 1 and all_dup:
        deg[0] = all_dup
    if n > 2 and hub:
        deg[n - 1] = hub
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.shape[0])
    cols[1::2] = cols[::2][:cols[1::2].shape[0]]
    if n > 1 and all_dup:
        cols[:all_dup] = n - 1
    if n > 2 and hub:
        cols[-hub:] = rng.permutation(n)[:hub] if hub <= n else \
            rng.integers(0, n, size=hub)
    vals = rng.random(rows.shape[0]).astype(np.float32)
    return rows, cols, vals


def csr_of(rows, cols, vals, n, device):
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return CsrMatrix.from_numpy(indptr, cols, vals, device)


@pytest.mark.parametrize("n", [1, 57, 300])
def test_k6_plain_matches_jax(n):
    jalg = pytest.importorskip("cleora_tpu.algorithms")
    rows, cols, vals = markov_coo(n, n)
    want_p, want_deg, want_vol = (np.asarray(a) for a in jalg._dense_markov(
        rows.astype(np.int32), cols.astype(np.int32), vals, n))
    kernels.reset_launches()
    p, deg, vol = dense_markov(csr_of(rows, cols, vals, n, CPU))
    assert kernels.LAUNCHES["dense_markov"] == 0
    assert p.dtype == torch.float32 and p.shape == (n, n)
    assert deg.dtype == torch.float32 and vol.dtype == torch.float64
    np.testing.assert_allclose(p.numpy(), want_p, rtol=0, atol=1e-6)
    np.testing.assert_allclose(deg.numpy(), want_deg, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vol.numpy()[0], want_vol, rtol=1e-6)
    assert not p[n // 2].any() and float(deg[n // 2]) == np.float32(1e-10)


def first_design_sum(v: np.ndarray) -> np.float32:
    """A row's float32 sum in the order K6 keeps from its first design:
    256 threads, thread t summing v[t::256] in turn from 0, an xor
    butterfly over each warp's 32 sums, then one over the 8 warp sums
    (lanes 8-31 holding 0)."""
    k = -(-v.shape[0] // 256)
    pad = np.zeros(max(k, 1) * 256, dtype=np.float32)
    pad[:v.shape[0]] = v
    s = np.zeros(256, dtype=np.float32)
    for chunk in pad.reshape(-1, 256):
        s = (s + chunk).astype(np.float32)
    lanes = np.arange(32)

    def butterfly(w):
        for off in (16, 8, 4, 2, 1):
            w = (w + w[lanes ^ off]).astype(np.float32)
        return w

    part = np.zeros(32, dtype=np.float32)
    part[:8] = [butterfly(s[32 * w:32 * w + 32])[0] for w in range(8)]
    return butterfly(part)[0]


@cuda
@pytest.mark.parametrize("n", [3, 4097, 20_000])
def test_k6_kernel_first_design_bits(cuda_device, n):
    rows, cols, vals = markov_coo(n, n, hub=5000, all_dup=16)
    csr = csr_of(rows, cols, vals, n, cuda_device)
    before = kernels.LAUNCHES["dense_markov"]
    p, deg, vol = dense_markov(csr)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dense_markov"] == before + 1
    p_plain, deg_plain, vol_plain = dense_markov_plain(csr)
    torch.testing.assert_close(p, p_plain, rtol=0.0, atol=1e-6)
    # the hub's row sum (about 2,500) in two float32 orders: relative
    torch.testing.assert_close(deg, deg_plain, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(vol, vol_plain, rtol=1e-6, atol=0.0)
    indptr = csr.indptr.cpu().numpy()
    want_deg = np.array([max(first_design_sum(vals[indptr[r]:indptr[r + 1]]),
                             np.float32(1e-10)) for r in range(n)],
                        dtype=np.float32)
    assert deg.cpu().numpy().tobytes() == want_deg.tobytes()
    # P bitwise val / deg (IEEE division) on every row without duplicates
    got = p.cpu().numpy()
    clean = 0
    for r in range(n):
        c = cols[indptr[r]:indptr[r + 1]]
        if np.unique(c).shape[0] != c.shape[0]:
            continue
        want = np.zeros(n, dtype=np.float32)
        want[c] = vals[indptr[r]:indptr[r + 1]] / want_deg[r]
        assert got[r].tobytes() == want.tobytes(), r
        clean += 1
    assert clean > 0
    assert not got[n // 2].any()


# ------------------------------------------------------------------ K4


def old_weights(csr: CsrMatrix, xn: torch.Tensor,
                temperature: float) -> torch.Tensor:
    """K4's plain version as it was before it normalised its input: the
    same segment ops on an already normalised ``xn``."""
    rows, cols = csr.plain_index()
    n = csr.n_rows
    t = torch.tensor(temperature, dtype=torch.float32)
    scores = torch.sum(xn.index_select(0, rows) * xn.index_select(0, cols),
                       dim=1) / t
    valid = csr.vals != 0.0
    masked = torch.where(valid, scores, float("-inf"))
    row_max = torch.full((n,), float("-inf")).scatter_reduce(
        0, rows, masked, "amax")
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    exp_scores = torch.where(valid, torch.exp(masked - row_max[rows]), 0.0)
    denom = torch.zeros(n).index_add_(0, rows, exp_scores)
    weighted = exp_scores / torch.clamp_min(denom, 1e-10)[rows] * csr.vals
    wsum = torch.zeros(n).index_add_(0, rows, weighted)
    return weighted / torch.clamp_min(wsum, 1e-10)[rows]


@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("d", [7, 8, 33, 1028])
def test_k4_plain_takes_the_raw_state(temperature, d):
    from test_torch_modes import attention_csr, numpy_attention_weights

    indptr, cols, vals = attention_csr(seed=d)
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((400, d)) * rng.uniform(0.1, 10, (400, 1))
         ).astype(np.float32)
    x[5] = 0.0  # a zero row: its norm clamps at 1e-10
    csr = CsrMatrix.from_numpy(indptr, cols, vals, CPU)
    raw = torch.from_numpy(x)
    kernels.reset_launches()
    got = edge_attention_weights(csr, raw, temperature)
    assert kernels.LAUNCHES["edge_attention"] == 0
    assert torch.equal(raw, torch.from_numpy(x))  # x is left as it was
    assert torch.equal(got, edge_attention_weights_plain(csr, raw,
                                                         temperature))
    xn = l2_normalize_plain(raw.clone())
    assert torch.equal(got, old_weights(csr, xn, temperature))
    want = numpy_attention_weights(indptr, cols, vals, xn.numpy(),
                                   temperature)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_wide_embed_with_attention_matches_jax():
    ct = pytest.importorskip("cleora_tpu")
    import cleora_tpu_torch as ctt
    from cleora_tpu_torch.convert import from_jax_state

    rng = np.random.default_rng(400)
    ref = ct.SparseMatrix.from_edge_arrays(rng.integers(0, 400, 1200),
                                           rng.integers(0, 400, 1200))
    ours = from_jax_state(ref.__getstate__())
    kw = dict(feature_dim=1028, num_iterations=2, whiten=False)
    got = ctt.embed_with_attention(ours, device="cpu", **kw)
    assert got.shape == (ref.num_entities, 1028)
    np.testing.assert_allclose(got, ct.embed_with_attention(ref, **kw),
                               rtol=1e-4, atol=1e-5)


def hub_csr(n, hub, seed):
    """Random CSR of n rows with empty rows, a row whose values are all 0,
    scattered zero values and row 1 a hub of ``hub`` entries."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(5, size=n)
    deg[::11] = 0
    deg[1] = hub
    deg[3] = max(deg[3], 4)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n, size=int(indptr[-1]))
    vals = rng.random(cols.shape[0]).astype(np.float32)
    vals[rng.random(cols.shape[0]) < 0.1] = 0.0
    vals[indptr[3]:indptr[4]] = 0.0
    return indptr, cols, vals


@cuda
@pytest.mark.parametrize("d", [7, 8, 300, 1028, 2052, 4096])
@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("sliced", [True, False])
def test_k4_kernel_raw_state(cuda_device, d, temperature, sliced):
    """K4 through ``edge_attention_weights`` (the hub in slices and a join)
    and with every row walked by its own team (the hub's early scores
    kept in ``out``)."""
    indptr, cols, vals = hub_csr(3000, 50_000, d)
    csr = CsrMatrix.from_numpy(indptr, cols, vals, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn((3000, d), device=cuda_device, generator=gen)
    x *= torch.rand((3000, 1), device=cuda_device, generator=gen) * 10
    x[7] = 0.0
    before = kernels.LAUNCHES["edge_attention"]
    if sliced:
        assert csr.hub_plan().split.shape[0] == 1
        got = edge_attention_weights(csr, x, temperature)
    else:
        got = kernels.edge_attention(csr.indptr, csr.indices, csr.vals, x,
                                     temperature)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["edge_attention"] == before + 1
    want = edge_attention_weights_plain(csr, x, temperature)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.all(got[int(indptr[3]):int(indptr[4])] == 0.0)
    assert torch.all(got[csr.vals == 0.0] == 0.0)


@cuda
def test_wide_attention_step_launches(cuda_device):
    indptr, cols, vals = hub_csr(2000, 300, 5)
    csr = CsrMatrix.from_numpy(indptr, cols, vals, cuda_device)
    x = torch.randn((2000, 1028), device=cuda_device)
    kernels.reset_launches()
    y = attention_step(csr, x, 0.7, "l2")
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert launches == {"row_normalize": 1, "edge_attention": 1,
                        "spmm_csr": 1}, launches
    torch.testing.assert_close(y, attention_spmm_plain(csr, x, 0.7, "l2"),
                               rtol=1e-5, atol=1e-6)
