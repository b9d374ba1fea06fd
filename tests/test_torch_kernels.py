"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every comparison here carries the ``cuda``
marker and skips without a card; the wrappers' argument checks need none
and run everywhere.  The file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels.py

Tolerances: K1 float32 rtol=1e-5, atol=1e-6 (the same float32 products,
summed in another order by the plain version's atomics); bf16 x atol=1e-2;
K2 atol=1e-6; K3 bitwise (integer arithmetic, exact conversions); K4
rtol=1e-5, atol=1e-6 (dot products and row sums in another order); K5
rtol=1e-5, atol=1e-6 (the row sum in another order; the tail is rounded
like the plain version's); K6 P and deg atol=1e-6, vol rtol=1e-6 (float32
row sums and the float64 total in another order); K7 atol=1e-6 (the same
float32 operations and the same logf); K8, K9 and K10 bitwise (integer
arithmetic and one exactly repeated float32 product per hop); K11 column
sums and row pointers bitwise, values rtol=1e-6 (the same float32
operations in the same order, another logf); K12 bitwise (the same Philox
words and the same round-to-nearest float32 operations in the same order);
K13 bitwise (the same float32 adds in the same order); K14 rtol=1e-5,
atol=1e-6 with clamped rows bitwise (the tail rounded like the plain
version's, the row sum in another order than the plain version's atomics:
about 7e-6 relative on a row of 5,000 edges); K15 bitwise (the same Philox
words, comparisons and true divisions); the GCN SpMM's backward (K1 over
Âᵀ) rtol=1e-5, atol=1e-6, as K1; K16 bitwise (a copy); K1 with a
separate residual operand as K1; K17 and K18 bitwise (K8's and K12's
arithmetic on each rank's rows; one nonzero term per summed lane); K19
rtol=1e-5, atol=1e-6 in float32 and bfloat16 (exact bf16→float32 loads;
the row sum in another order than the plain version's atomics), and
bitwise K1 over a round that holds every edge (K1's loop, in K1's order).
"""

import numpy as np
import pytest
import torch

from cleora_tpu_torch import kernels
from cleora_tpu_torch.graph.hashing import init_embeddings
from cleora_tpu_torch.ops.attention import (
    edge_attention_weights,
    edge_attention_weights_plain,
)
from cleora_tpu_torch.ops.init import (
    device_init,
    device_init_plain,
    hashes_as_int64,
)
from cleora_tpu_torch.ops.normalize import (
    l1_normalize_plain,
    l2_normalize_plain,
    normalize,
)
from cleora_tpu_torch.algorithms import _GRAREP_FLOOR, _GRAREP_OFFSET
from cleora_tpu_torch.kernels import build
from cleora_tpu_torch.ops import cooccur
from cleora_tpu_torch.ops.dense import (
    dense_markov,
    dense_markov_plain,
    log_clip,
    log_clip_plain,
)
from cleora_tpu_torch.ops.gcn import (
    CsrSpmm,
    relu_dropout,
    relu_dropout_backward,
    relu_dropout_backward_plain,
    relu_dropout_plain,
)
from cleora_tpu_torch.ops.label_prop import (
    label_prop_step,
    label_prop_step_plain,
)
from cleora_tpu_torch.ops.halo import halo_pack, halo_pack_plain
from cleora_tpu_torch.ops.pq import pq_adc_plain
from cleora_tpu_torch.ops.walk import (
    ShardedWalkTables,
    WalkTables,
    WalkTables2,
    walk2_tries,
    walk_p_q_plain,
    walk_p_q_sharded,
    walk_uniform_plain,
    walk_uniform_sharded,
)
from cleora_tpu_torch.ops.spmm import (
    CsrMatrix,
    spmm,
    spmm_acc,
    spmm_acc_plain,
    spmm_axpy,
    spmm_axpy_plain,
    spmm_plain,
)

cuda = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def markov_csr(n, seed, hub_degree):
    """Left-Markov CSR (rows sum to 1) with zero-degree rows and row 1 of
    degree ``hub_degree``."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, size=n)
    deg[::7] = 0
    deg[1] = hub_degree
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n, size=int(indptr[-1]))
    vals = (1.0 / np.maximum(deg, 1))[np.repeat(np.arange(n), deg)]
    return indptr, cols, vals.astype(np.float32)


@pytest.mark.parametrize("d", [8, 256, 300, 7, 4096])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [0.0, 0.3])
@cuda
def test_k1_matches_plain(cuda_device, d, x_dtype, w):
    csr = CsrMatrix.from_numpy(*markov_csr(3000, d, 5000), cuda_device)
    x = torch.randn((3000, d), device=cuda_device).to(x_dtype)
    before = kernels.LAUNCHES["spmm_csr"]
    out = spmm(csr, x, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmm_csr"] == before + 1
    tol = ({"rtol": 1e-5, "atol": 1e-6} if x_dtype == torch.float32
           else {"rtol": 0.0, "atol": 1e-2})
    torch.testing.assert_close(out, spmm_plain(csr, x, w), **tol)


@pytest.mark.parametrize("method", ["l2", "l1"])
@pytest.mark.parametrize("d", [8, 256, 300, 7])
@cuda
def test_k2_matches_plain(cuda_device, method, d):
    x = torch.randn((500, d), device=cuda_device)
    x[3] = 0.0
    before = kernels.LAUNCHES["row_normalize"]
    out = normalize(x.clone(), method)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["row_normalize"] == before + 1
    plain = {"l2": l2_normalize_plain, "l1": l1_normalize_plain}[method]
    torch.testing.assert_close(out, plain(x.clone()), rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("d", [1, 7, 256, 300])
@pytest.mark.parametrize("seed", [0, 7, -3, 2**40 + 5])
@cuda
def test_k3_bitwise(cuda_device, d, seed):
    h = np.random.default_rng(d).integers(0, 2**64 - 1, size=5000,
                                          dtype=np.uint64, endpoint=True)
    h[:4] = [0, 2**64 - 1, 2**63, 2**63 + 1]
    t = hashes_as_int64(h).to(cuda_device)
    before = kernels.LAUNCHES["hash_init"]
    out = device_init(t, d, seed)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hash_init"] == before + 1
    assert out.cpu().numpy().tobytes() == init_embeddings(h, d, seed).tobytes()
    assert torch.equal(out, device_init_plain(t, d, seed))


@pytest.mark.parametrize("d", [8, 256, 300])
@pytest.mark.parametrize("temperature", [0.7, 1.0])
@cuda
def test_k4_matches_plain(cuda_device, d, temperature):
    indptr, cols, vals = markov_csr(3000, d, 5000)
    vals[indptr[2]:indptr[3]] = 0.0  # a row whose values are all 0
    vals[::13] = 0.0
    csr = CsrMatrix.from_numpy(indptr, cols, vals, cuda_device)
    x = torch.randn((3000, d), device=cuda_device)
    xn = x / x.norm(dim=1, keepdim=True).clamp_min(1e-10)
    before = kernels.LAUNCHES["edge_attention"]
    out = edge_attention_weights(csr, xn, temperature)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["edge_attention"] == before + 1
    torch.testing.assert_close(
        out, edge_attention_weights_plain(csr, xn, temperature),
        rtol=1e-5, atol=1e-6)
    assert torch.all(out[int(indptr[2]):int(indptr[3])] == 0.0)


@cuda
@pytest.mark.parametrize("d", [8, 136, 300, 7, 4096])
@pytest.mark.parametrize("case", ["randne", "chebyshev", "katz", "bare"])
def test_k5_matches_plain(cuda_device, d, case):
    csr = CsrMatrix.from_numpy(*markov_csr(3000, d, 5000), cuda_device)
    x, z, acc = (torch.randn((3000, d), device=cuda_device) for _ in range(3))
    kw = {"randne": dict(a=1.0, acc=acc, d=0.25),
          "chebyshev": dict(a=-2.0, b=2.0, z=z, c=-1.0, acc=acc, d=0.05),
          "katz": dict(a=0.1, acc=acc, d=1.0),
          "bare": dict(a=-1.0, b=1.0)}[case]
    plain_kw = dict(kw)
    if "acc" in kw:
        plain_kw["acc"] = acc.clone()
    before = kernels.LAUNCHES["spmm_axpy"]
    out = spmm_axpy(csr, x, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmm_axpy"] == before + 1
    want = spmm_axpy_plain(csr, x, **plain_kw)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    if "acc" in kw:
        torch.testing.assert_close(acc, plain_kw["acc"], rtol=1e-5, atol=1e-6)


@cuda
@pytest.mark.parametrize("n", [1, 2, 257, 1024])
def test_k6_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    deg = rng.poisson(5, size=n) + 1
    deg[n // 2] = 0  # an empty row
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n, size=int(indptr[-1]))
    cols[1::2] = cols[::2][:cols[1::2].shape[0]]  # duplicate entries
    vals = rng.random(cols.shape[0]).astype(np.float32)
    csr = CsrMatrix.from_numpy(indptr, cols, vals, cuda_device)
    before = kernels.LAUNCHES["dense_markov"]
    p, d, vol = dense_markov(csr)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dense_markov"] == before + 1
    p_plain, d_plain, vol_plain = dense_markov_plain(csr)
    torch.testing.assert_close(p, p_plain, rtol=0.0, atol=1e-6)
    torch.testing.assert_close(d, d_plain, rtol=0.0, atol=1e-6)
    torch.testing.assert_close(vol, vol_plain, rtol=1e-6, atol=0.0)
    assert not p[n // 2].any() and float(d[n // 2]) == np.float32(1e-10)


@cuda
@pytest.mark.parametrize("shape", [(512, 512), (100, 300), (33, 7), (1, 1)])
@pytest.mark.parametrize("mode", ["netmf", "grarep"])
@pytest.mark.parametrize("scaled", [True, False])
def test_k7_matches_plain(cuda_device, shape, mode, scaled):
    n, m = shape
    x = torch.rand((n, m), device=cuda_device) * 4
    x[x < 1.0] = 0.0
    r = torch.rand(n, device=cuda_device) + 0.5 if scaled else None
    c = torch.rand(m, device=cuda_device) + 0.5 if scaled else None
    floor, offset = ((1.0, 0.0) if mode == "netmf"
                     else (_GRAREP_FLOOR, _GRAREP_OFFSET))
    before = kernels.LAUNCHES["log_clip"]
    t = x.clone()
    out = log_clip(t, r, c, floor, offset)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["log_clip"] == before + 1
    assert out.data_ptr() == t.data_ptr()  # in place
    torch.testing.assert_close(
        out, log_clip_plain(x.clone(), r, c, floor, offset), rtol=0.0,
        atol=1e-6)


def walk_csr(n, seed):
    """A walk CSR (indptr, cols, deg) with dead ends (every 9th node has
    degree 0) and one hub of degree 3000."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(5, size=n)
    deg[::9] = 0
    deg[1] = 3000
    indptr = np.concatenate([[0], np.cumsum(deg)[:-1]])
    cols = rng.integers(0, n, size=int(deg.sum()))
    return indptr, cols, deg


def walk_tables(n, seed, device):
    return WalkTables(*walk_csr(n, seed), n, device)


def sample_walks(device, n=2000, batch=1500, length=12, seed=3):
    t = walk_tables(n, seed, device)
    starts = torch.randint(0, n + 1, (batch,), device=device,
                           dtype=torch.int32)  # n: pad lanes
    return kernels.walk_uniform(t.indptr, t.cols, t.deg, starts, length,
                                seed, 0, n), n


@cuda
@pytest.mark.parametrize("length", [1, 2, 80])
@pytest.mark.parametrize("seed", [0, 2**40 + 3, -1])
@pytest.mark.parametrize("base", [0, 2**33 + 5])
def test_k8_bitwise(cuda_device, length, seed, base):
    n = 3000
    t = walk_tables(n, 1, cuda_device)
    starts = torch.randint(0, n + 1, (4099,), device=cuda_device,
                           dtype=torch.int32)
    before = kernels.LAUNCHES["walk_uniform"]
    got = kernels.walk_uniform(t.indptr, t.cols, t.deg, starts, length, seed,
                               base, n)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["walk_uniform"] == before + 1
    want = walk_uniform_plain(t.indptr, t.cols, t.deg, starts, length, seed,
                              base, n)
    assert got.shape == (4099, length) and torch.equal(got, want)
    cpu = walk_uniform_plain(t.indptr.cpu(), t.cols.cpu(), t.deg.cpu(),
                             starts.cpu(), length, seed, base, n)
    assert torch.equal(got.cpu(), cpu)


@cuda
@pytest.mark.parametrize("window", [1, 5, 11, 40])
@pytest.mark.parametrize("passes", [1, 3, 8])
def test_k9_bitwise(cuda_device, window, passes):
    walks, n = sample_walks(cuda_device)
    n_valid = walks.shape[0] - 7
    before = kernels.LAUNCHES["pair_enum"]
    got = kernels.pair_enum(walks, n_valid, n, window, passes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pair_enum"] == before + 1
    assert torch.equal(got, cooccur.pair_keys_plain(walks, n_valid, n, window,
                                                    passes))


@cuda
@pytest.mark.parametrize("passes", [1, 3, 8])
def test_k10_bitwise_after_the_sweep_and_a_merge(cuda_device, passes):
    walks, n = sample_walks(cuda_device)
    keys = torch.sort(kernels.pair_enum(walks, walks.shape[0] - 5, n, 5,
                                        passes)).values
    before = kernels.LAUNCHES["run_length"]
    got = kernels.run_length(keys, None, n, passes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["run_length"] == before + 1
    want = cooccur.run_length_plain(keys, None, n, passes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # a merge: two halves of the runs, concatenated, sorted with payload
    cen, ctx, cnt, _ = got
    h = cen.shape[0] // 2
    a = (cen[:h], ctx[:h], cnt[:h], h)
    b = (cen[h // 2:], ctx[h // 2:], cnt[h // 2:] * 3, cen.shape[0] - h // 2)
    merged = cooccur._merge(a, b, n)
    k2 = torch.sort(torch.cat([a[0].long() * n + a[1],
                               b[0].long() * n + b[1]]))
    plain = cooccur.run_length_plain(
        k2.values, torch.cat([a[2], b[2]])[k2.indices], n, 1)
    for x, y in zip(merged[:3], plain[:3]):
        assert torch.equal(x, y)
    assert merged[3] == cen.shape[0]


@cuda
@pytest.mark.parametrize("passes", [1, 3])
def test_k11_matches_plain(cuda_device, passes):
    walks, n = sample_walks(cuda_device)
    ranges, _ = cooccur.device_pair_counts(lambda: [(walks, 3)], n, 5,
                                           passes=passes)
    z = lambda: (torch.zeros(n, dtype=torch.int64, device=cuda_device),
                 torch.zeros(1, dtype=torch.int64, device=cuda_device))
    col, total = z()
    col_p, total_p = z()
    for _, ctx, cnt, _ in ranges:
        kernels.ppmi_colsum_(ctx, cnt, col, total)
        cooccur.ppmi_colsum_plain(ctx, cnt, col_p, total_p)
    torch.cuda.synchronize()
    assert torch.equal(col, col_p) and torch.equal(total, total_p)
    for cen, ctx, cnt, _ in ranges:
        before = kernels.LAUNCHES["ppmi"]
        vals, indptr = kernels.ppmi(cen, ctx, cnt, col, total, n)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["ppmi"] == before + 1
        want_vals, want_indptr = cooccur.ppmi_values_plain(cen, ctx, cnt, col,
                                                           total, n)
        assert torch.equal(indptr, want_indptr)
        torch.testing.assert_close(vals, want_vals, rtol=1e-6, atol=0.0)


def weighted_walk_tables(n, seed, device, hub_degree=3000):
    arrays = weighted_walk_csr(n, seed, hub_degree)
    return WalkTables2(*arrays[:3], n, *arrays[3:], device)


def weighted_walk_csr(n, seed, hub_degree=3000):
    """A weighted walk CSR (indptr, cols, deg, vals, wmax, wsum) with
    (row, col)-sorted rows, one hub (node 1), a row whose weights are all 0
    (node 2) and an isolated node (n - 1)."""
    rng = np.random.default_rng(seed)
    m = 3 * n
    src = np.concatenate([rng.integers(0, n - 1, m), np.ones(hub_degree,
                                                             np.int64)])
    dst = np.concatenate([rng.integers(0, n - 1, m),
                          rng.choice(n - 1, hub_degree, replace=False)])
    keys = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    rows, cols = keys // n, keys % n
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(0.05, 3.0, rows.shape[0]).astype(np.float32)
    vals[rows == 2] = 0.0
    deg = np.bincount(rows, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)[:-1]])
    wmax = np.zeros(n, np.float32)
    np.maximum.at(wmax, rows, vals)
    wsum = np.zeros(n, np.float64)
    np.add.at(wsum, rows, vals.astype(np.float64))
    return indptr, cols, deg, vals, wmax, wsum.astype(np.float32)


@cuda
@pytest.mark.parametrize("p,q", [(0.5, 2.0), (4.0, 0.25), (0.01, 1.0),
                                 (1.0, 100.0)])
@pytest.mark.parametrize("batch", [1, 4099])
def test_k12_bitwise(cuda_device, p, q, batch):
    n = 4000
    t = weighted_walk_tables(n, 2, cuda_device)
    starts = torch.randint(0, n + 1, (batch,), device=cuda_device,
                           dtype=torch.int32)  # n: pad lanes
    starts[0] = 1  # the hub
    args = (t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum, starts, 20,
            1.0 / p, 1.0 / q, walk2_tries(q), 2**40 + 7, 3)
    before = kernels.LAUNCHES["walk_p_q"]
    got = kernels.walk_p_q(*args, n)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["walk_p_q"] == before + 1
    assert got.shape == (batch, 20)
    assert torch.equal(got, walk_p_q_plain(*args, n))
    cpu = walk_p_q_plain(*(a.cpu() if torch.is_tensor(a) else a
                           for a in args), n)
    assert torch.equal(got.cpu(), cpu)


def _adc_case(q, m, c, n, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    tables = torch.randn((q, m, c), generator=gen)
    codes = torch.randint(0, c, (n, m), generator=gen, dtype=torch.int32)
    return tables.to(device), codes.to(dtype).to(device)


@cuda
@pytest.mark.parametrize("q,m,c,n,dtype", [
    (1, 8, 256, 1000, torch.uint8),
    (37, 8, 256, 20000, torch.uint8),
    (64, 4, 300, 5000, torch.uint16),
    (9, 16, 16, 777, torch.int32),
    (3, 64, 1024, 500, torch.int32),  # 256 KiB per query: gathers from HBM
])
def test_k13_bitwise(cuda_device, q, m, c, n, dtype):
    tables, codes = _adc_case(q, m, c, n, dtype, cuda_device)
    before = kernels.LAUNCHES["pq_adc"]
    got = kernels.pq_adc(tables, codes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pq_adc"] == before + 1
    assert got.shape == (q, n) and torch.equal(got, pq_adc_plain(tables,
                                                                 codes))


@cuda
@pytest.mark.parametrize("d", [8, 256, 300])
def test_k5_self_operand_matches_plain(cuda_device, d):
    """The sharded siblings' K5: a 3,000-row gather table under a
    2,000-row CSR, ``b·self_`` read from the shard's own rows, with
    Chebyshev's coefficients."""
    indptr, _, vals = markov_csr(2000, d, 500)
    cols = np.random.default_rng(d).integers(0, 3000, size=vals.shape[0])
    csr = CsrMatrix(torch.from_numpy(indptr).to(cuda_device),
                    torch.from_numpy(cols.astype(np.int32)).to(cuda_device),
                    torch.from_numpy(vals).to(cuda_device))
    table = torch.randn((3000, d), device=cuda_device)
    own, z, acc = (torch.randn((2000, d), device=cuda_device)
                   for _ in range(3))
    want_acc = acc.clone()
    before = kernels.LAUNCHES["spmm_axpy"]
    out = spmm_axpy(csr, table, -2.0, 2.0, z=z, c=-1.0, acc=acc, d=0.05,
                    self_=own)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmm_axpy"] == before + 1
    want = spmm_axpy_plain(csr, table, -2.0, 2.0, z=z, c=-1.0, acc=want_acc,
                           d=0.05, self_=own)
    assert out.shape == (2000, d)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(acc, want_acc, rtol=1e-5, atol=1e-6)


# ------------------------------------------- argument checks (need no card)
def test_k5_wrapper_checks_the_self_operand():
    """With ``self_`` the gather table may have any number of rows; the
    shard's own rows, z and acc have one per row of A."""
    indptr, indices, vals = _cpu_csr()
    table, own = torch.zeros((30, 8)), torch.zeros((20, 8))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="self_ must have one row per row"):
        kernels.spmm_axpy(indptr, indices, vals, table, 1.0, self_=table)
    with pytest.raises(ValueError, match="shapes differ"):
        kernels.spmm_axpy(indptr, indices, vals, table, 1.0, self_=own,
                          acc=torch.zeros((20, 4)))
    with pytest.raises(ValueError, match="must not share"):
        kernels.spmm_axpy(indptr, indices, vals, table, 1.0, self_=own,
                          acc=own, d=1.0)
    with pytest.raises(ValueError, match="CUDA"):  # the table's 30 rows pass
        kernels.spmm_axpy(indptr, indices, vals, table, 1.0, b=1.0,
                          self_=own)
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def _cpu_csr(n=20):
    indptr = torch.arange(n + 1, dtype=torch.int64)
    return (indptr, torch.zeros(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.float32))


def test_k5_wrapper_rejects_bad_operands():
    indptr, indices, vals = _cpu_csr()
    x = torch.zeros((20, 8))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.spmm_axpy(indptr, indices, vals, x, 1.0)
    with pytest.raises(ValueError, match="indptr int64"):
        kernels.spmm_axpy(indptr.int(), indices, vals, x, 1.0)
    with pytest.raises(ValueError, match="2-D float32"):
        kernels.spmm_axpy(indptr, indices, vals, x.double(), 1.0)
    with pytest.raises(ValueError, match="2-D float32"):
        kernels.spmm_axpy(indptr, indices, vals, x, 1.0, z=x.half())
    with pytest.raises(ValueError, match="shapes differ"):
        kernels.spmm_axpy(indptr, indices, vals, x, 1.0, acc=x[:, :4])
    with pytest.raises(ValueError, match="one row per row"):
        kernels.spmm_axpy(indptr, indices, vals, x[:10], 1.0)
    with pytest.raises(ValueError, match="must not share"):
        kernels.spmm_axpy(indptr, indices, vals, x, 1.0, acc=x, d=1.0)
    # overlapping views of one buffer, and z in acc's place, are caught too
    buf = torch.zeros((30, 8))
    with pytest.raises(ValueError, match="must not share"):
        kernels.spmm_axpy(indptr, indices, vals, buf[:20], 1.0, acc=buf[10:],
                          d=1.0)
    with pytest.raises(ValueError, match="must not share"):
        kernels.spmm_axpy(indptr, indices, vals, x, 1.0, z=buf[:20], c=1.0,
                          acc=buf[:20], d=1.0)
    # neighbouring halves of one buffer do not overlap: the next check speaks
    buf = torch.zeros((40, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.spmm_axpy(indptr, indices, vals, buf[:20], 1.0, acc=buf[20:],
                          d=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.spmm_axpy(indptr, indices, vals, torch.zeros((8, 20)).T, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.spmm_axpy(indptr, indices, vals, x, 1.0,
                          acc=torch.zeros((20, 16))[:, ::2])
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_k6_wrapper_rejects_bad_operands():
    indptr, indices, vals = _cpu_csr()
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dense_markov(indptr, indices, vals)
    with pytest.raises(ValueError, match="vals float32"):
        kernels.dense_markov(indptr, indices, vals.double())
    with pytest.raises(ValueError, match="indices int32"):
        kernels.dense_markov(indptr, indices.long(), vals)
    with pytest.raises(ValueError, match="mismatch"):
        kernels.dense_markov(indptr, indices, vals[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.dense_markov(indptr, indices, torch.ones(40)[::2])
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_k7_wrapper_rejects_bad_operands():
    x = torch.ones((6, 8))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.log_clip_(x, None, None, 1.0, 0.0)
    with pytest.raises(ValueError, match="float32"):
        kernels.log_clip_(x.double(), None, None, 1.0, 0.0)
    with pytest.raises(ValueError, match="float32"):
        kernels.log_clip_(x, torch.ones(6).double(), None, 1.0, 0.0)
    with pytest.raises(ValueError, match="2-D"):
        kernels.log_clip_(x[0], None, None, 1.0, 0.0)
    with pytest.raises(ValueError, match="per row"):
        kernels.log_clip_(x, torch.ones(8), None, 1.0, 0.0)
    with pytest.raises(ValueError, match="per column"):
        kernels.log_clip_(x, None, torch.ones(6), 1.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.log_clip_(torch.ones((8, 6)).T, None, None, 1.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.log_clip_(x, torch.ones(12)[::2], None, 1.0, 0.0)
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_walk_and_count_wrappers_reject_bad_operands():
    t = WalkTables(np.array([0, 1]), np.array([1, 0]), np.array([1, 1]), 2,
                   torch.device("cpu"))
    starts = torch.zeros(4, dtype=torch.int32)
    walks = torch.zeros((4, 6), dtype=torch.int32)
    keys = torch.arange(10, dtype=torch.int64)
    i32 = torch.zeros(10, dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.walk_uniform(t.indptr, t.cols, t.deg, starts, 5, 0, 0, 2)
    with pytest.raises(ValueError, match="int32"):
        kernels.walk_uniform(t.indptr, t.cols, t.deg, starts.long(), 5, 0, 0,
                             2)
    with pytest.raises(ValueError, match="one entry per node"):
        kernels.walk_uniform(t.indptr, t.cols, t.deg, starts, 5, 0, 0, 3)
    with pytest.raises(ValueError, match="walk_length >= 1"):
        kernels.walk_uniform(t.indptr, t.cols, t.deg, starts, 0, 0, 0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pair_enum(walks, 4, 2, 5, 1)
    with pytest.raises(ValueError, match="2-D int32"):
        kernels.pair_enum(walks.long(), 4, 2, 5, 1)
    with pytest.raises(ValueError, match="2\\^63"):
        kernels.pair_enum(walks, 4, 1 << 31, 5, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.run_length(keys, None, 4, 1)
    with pytest.raises(ValueError, match="int64"):
        kernels.run_length(keys.int(), None, 4, 1)
    with pytest.raises(ValueError, match="one entry per key"):
        kernels.run_length(keys, i32[:5], 4, 1)
    with pytest.raises(ValueError, match="passes"):
        kernels.run_length(keys, None, 4, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ppmi_colsum_(i32, i32, torch.zeros(4, dtype=torch.int64),
                             torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        kernels.ppmi(i32, i32, i32, torch.zeros(4), torch.zeros(1), 4)
    with pytest.raises(ValueError, match="one 1-D shape"):
        kernels.ppmi(i32, i32, i32[:3], torch.zeros(4, dtype=torch.int64),
                     torch.zeros(1, dtype=torch.int64), 4)
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_k12_and_k13_wrappers_reject_bad_operands():
    t = WalkTables2(np.array([0, 1]), np.array([1, 0]), np.array([1, 1]), 2,
                    np.ones(2), np.ones(2), np.ones(2), torch.device("cpu"))
    starts = torch.zeros(4, dtype=torch.int32)
    tab = (t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.walk_p_q(*tab, starts, 5, 1.0, 1.0, 64, 0, 0, 2)
    with pytest.raises(ValueError, match="int32"):
        kernels.walk_p_q(*tab, starts.long(), 5, 1.0, 1.0, 64, 0, 0, 2)
    with pytest.raises(ValueError, match="float32"):
        kernels.walk_p_q(t.indptr, t.cols, t.vals.double(), *tab[3:], starts,
                         5, 1.0, 1.0, 64, 0, 0, 2)
    with pytest.raises(ValueError, match="one entry per node"):
        kernels.walk_p_q(*tab, starts, 5, 1.0, 1.0, 64, 0, 0, 3)
    with pytest.raises(ValueError, match="vals must match cols"):
        kernels.walk_p_q(t.indptr, t.cols, t.vals[:1], *tab[3:], starts, 5,
                         1.0, 1.0, 64, 0, 0, 2)
    with pytest.raises(ValueError, match="tries >= 1"):
        kernels.walk_p_q(*tab, starts, 5, 1.0, 1.0, 0, 0, 0, 2)
    tables, codes = _adc_case(2, 4, 16, 10, torch.uint8, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pq_adc(tables, codes)
    with pytest.raises(ValueError, match="3-D float32"):
        kernels.pq_adc(tables.double(), codes)
    with pytest.raises(ValueError, match="uint8, uint16 or int32"):
        kernels.pq_adc(tables, codes.long())
    with pytest.raises(ValueError, match="one column per subspace"):
        kernels.pq_adc(tables, codes[:, :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.pq_adc(tables, codes.T.contiguous().T)
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_walk_tables2_reject_unsorted_rows_and_bad_weights():
    cpu = torch.device("cpu")
    one = np.ones(3)
    with pytest.raises(ValueError, match="sorted"):
        WalkTables2(np.array([0, 2, 3]), np.array([2, 1, 0]),
                    np.array([2, 1, 0]), 3, one, one, one, cpu)
    with pytest.raises(ValueError, match="vals need one entry"):
        WalkTables2(np.array([0, 2, 3]), np.array([1, 2, 0]),
                    np.array([2, 1, 0]), 3, one[:2], one, one, cpu)
    # a descent between two rows is no fault
    WalkTables2(np.array([0, 2, 3]), np.array([1, 2, 0]),
                np.array([2, 1, 0]), 3, one, one, one, cpu)


def _label_state(n, c, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    mask = torch.rand((n,), device=device, generator=gen) < 0.3
    y = torch.zeros((n, c), device=device)
    cls = torch.randint(0, c, (n,), device=device, generator=gen)
    y[mask, cls[mask]] = 1.0
    f = torch.rand((n, c), device=device, generator=gen)
    return f, y, mask


@pytest.mark.parametrize("c", [2, 7, 40, 47])
@pytest.mark.parametrize("alpha", [0.5, 0.3])
@cuda
def test_k14_matches_plain(cuda_device, c, alpha):
    csr = CsrMatrix.from_numpy(*markov_csr(3000, c, 5000), cuda_device)
    f, y, mask = _label_state(3000, c, cuda_device)
    beta = float(np.float32(1) - np.float32(alpha))
    before = kernels.LAUNCHES["label_prop"]
    out = label_prop_step(csr, f, y, mask, alpha, beta)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["label_prop"] == before + 1
    want = label_prop_step_plain(csr, f, y, mask, alpha, beta)
    assert torch.equal(out[mask], y[mask])
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    # into a given buffer, as the propagation loop calls it
    buf = torch.empty_like(f)
    assert label_prop_step(csr, f, y, mask, alpha, beta, out=buf) is buf
    torch.cuda.synchronize()
    assert torch.equal(buf, out)


@pytest.mark.parametrize("shape", [(1, 1), (33, 7), (1001, 64), (517, 3)])
@pytest.mark.parametrize("p", [0.0, 0.5, 0.3])
@cuda
def test_k15_forward_and_backward_bitwise(cuda_device, shape, p):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    z = torch.randn(shape, device=cuda_device, generator=gen)
    z[0, 0] = 0.0  # ReLU's gradient at 0 is 0
    dh = torch.randn(shape, device=cuda_device, generator=gen)
    before = kernels.LAUNCHES["relu_dropout"]
    for epoch, layer, seed in ((0, 0, 42), (7, 1, 2**40 + 3), (199, 2, -1)):
        h = relu_dropout(z, p, seed, epoch, layer)
        dz = relu_dropout_backward(z, dh, p, seed, epoch, layer)
        torch.cuda.synchronize()
        assert torch.equal(h, relu_dropout_plain(z, p, seed, epoch, layer))
        assert torch.equal(
            dz, relu_dropout_backward_plain(z, dh, p, seed, epoch, layer))
        # the same mask as on the CPU, whatever the device
        assert torch.equal(
            h.cpu(), relu_dropout_plain(z.cpu(), p, seed, epoch, layer))
    assert kernels.LAUNCHES["relu_dropout"] == before + 6


@cuda
def test_gcn_spmm_backward_on_the_card_matches_plain(cuda_device):
    n = 3000
    indptr, cols, vals = markov_csr(n, 9, 5000)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    a = CsrMatrix.from_coo(rows, cols, vals, n, cuda_device)
    at = CsrMatrix.transpose_from_coo(rows, cols, vals, n, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    h = torch.randn((n, 64), device=cuda_device, generator=gen,
                    requires_grad=True)
    weight = torch.randn((n, 64), device=cuda_device, generator=gen)
    before = kernels.LAUNCHES["spmm_csr"]
    (CsrSpmm.apply(h, a, at) * weight).sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmm_csr"] == before + 2
    torch.testing.assert_close(h.grad, spmm_plain(at, weight), rtol=1e-5,
                               atol=1e-6)


def test_k14_and_k15_wrappers_reject_bad_operands():
    args = _cpu_csr()
    n = args[0].shape[0] - 1
    f = torch.zeros((n, 3))
    mask = torch.zeros((n,), dtype=torch.bool)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.label_prop(*args, f, f.clone(), mask, 0.5, 0.5)
    with pytest.raises(ValueError, match="2-D float32"):
        kernels.label_prop(*args, f.double(), f, mask, 0.5, 0.5)
    with pytest.raises(ValueError, match="one row per row"):
        kernels.label_prop(*args, f[:-1], f[:-1], mask, 0.5, 0.5)
    with pytest.raises(ValueError, match="bool"):
        kernels.label_prop(*args, f, f.clone(), mask.int(), 0.5, 0.5)
    with pytest.raises(ValueError, match="must not share memory"):
        kernels.label_prop(*args, f, f.clone(), mask, 0.5, 0.5, out=f)
    z = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.relu_dropout(z, 0.5, 0, 0, 0)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        kernels.relu_dropout(z, 1.5, 0, 0, 0)
    with pytest.raises(ValueError, match="32 bits"):
        kernels.relu_dropout(z, 0.5, 0, -1, 0)
    with pytest.raises(ValueError, match="float32"):
        kernels.relu_dropout(z.double(), 0.5, 0, 0, 0)
    with pytest.raises(ValueError, match="one shape"):
        kernels.relu_dropout_backward(z, z[:2], 0.5, 0, 0, 0)
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


@pytest.mark.parametrize("d", [7, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
@cuda
def test_k16_bitwise(cuda_device, d, dtype, offset):
    """Odd M, every width class (odd bf16 rows take 2-byte halves, float32
    rows of 7 words 4-byte words), and a state that starts one element
    past an aligned address (no 16-byte vectors then)."""
    rng = np.random.default_rng(d)
    rows, p, m = 1001, 3, 37
    base = torch.randn((rows * d + offset,), device=cuda_device).to(dtype)
    x = base[offset:].view(rows, d)
    idx = torch.from_numpy(
        rng.integers(0, rows, size=(p, m)).astype(np.int32)).to(cuda_device)
    before = kernels.LAUNCHES["halo_pack"]
    got = halo_pack(x, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["halo_pack"] == before + 1
    assert got.dtype == dtype and got.shape == (p, m, d)
    assert torch.equal(got, halo_pack_plain(x, idx))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@cuda
def test_k1_separate_residual_matches_plain(cuda_device, x_dtype):
    """The sharded loop's halo step: the gather table (here 500 rows) is
    smaller than the matrix (3,000 rows) and the residual comes from the
    shard's own state."""
    indptr, cols, vals = markov_csr(3000, 5, 400)
    cols = cols % 500
    csr = CsrMatrix(*(torch.from_numpy(a).to(cuda_device)
                      for a in (indptr, cols.astype(np.int32), vals)))
    table = torch.randn((500, 64), device=cuda_device).to(x_dtype)
    res = torch.randn((3000, 64), device=cuda_device).to(x_dtype)
    out = spmm(csr, table, 0.3, residual=res)
    torch.cuda.synchronize()
    tol = ({"rtol": 1e-5, "atol": 1e-6} if x_dtype == torch.float32
           else {"rtol": 0.0, "atol": 1e-2})
    torch.testing.assert_close(out, spmm_plain(csr, table, 0.3, res), **tol)


@cuda
def test_k16_packs_into_a_given_buffer(cuda_device):
    x = torch.randn((100, 16), device=cuda_device)
    idx = torch.randint(0, 100, (2, 9), dtype=torch.int32,
                        device=cuda_device)
    out = torch.empty((2, 9, 16), device=cuda_device)
    assert halo_pack(x, idx, out=out) is out
    torch.cuda.synchronize()
    assert torch.equal(out, halo_pack_plain(x, idx))
    with pytest.raises(ValueError, match="out must be"):
        kernels.halo_pack(x, idx, out[:1])
    with pytest.raises(ValueError, match="share memory"):
        kernels.halo_pack(x, idx[:, :6].contiguous(),
                          x.view(-1)[:192].view(2, 6, 16))


def _round_arrays(n_rows, n_table, seed, hub_degree=5000):
    """A round's compact CSR: every third row of ``n_rows``, one of them
    of degree ``hub_degree``, each row's values summing to at most 1 as
    in a left-Markov operator (so a row's sum does not cancel far below
    its terms, where two float32 summation orders part by more than the
    tolerance)."""
    rng = np.random.default_rng(seed)
    row_ids = np.arange(1, n_rows, 3, dtype=np.int32)
    deg = rng.poisson(5, size=row_ids.shape[0]) + 1
    deg[3] = hub_degree
    indptr = np.zeros(row_ids.shape[0] + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n_table, size=int(indptr[-1])).astype(np.int32)
    vals = (rng.random(int(indptr[-1]))
            / np.repeat(deg, deg)).astype(np.float32)
    return row_ids, indptr, cols, vals


@pytest.mark.parametrize("d", [7, 64, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
@cuda
def test_k19_matches_plain(cuda_device, d, dtype, offset):
    """A round over a slab (here 700 rows) into a 3,000-row accumulator,
    every width class, and a table that starts one element past an
    aligned address (the scalar path then)."""
    arrays = _round_arrays(3000, 700, d)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    base = torch.randn((700 * d + offset,), device=cuda_device).to(dtype)
    table = base[offset:].view(700, d)
    acc0 = torch.randn((3000, d), device=cuda_device)
    before = kernels.LAUNCHES["spmm_acc"]
    got = spmm_acc(acc0.clone(), *args, table)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmm_acc"] == before + 1
    want = spmm_acc_plain(acc0.clone(), *args, table)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    untouched = torch.ones(3000, dtype=torch.bool, device=cuda_device)
    untouched[args[0].long()] = False
    assert torch.equal(got[untouched], acc0[untouched])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@cuda
def test_k19_over_every_edge_is_k1(cuda_device, dtype):
    """Round 0 of one shard holds every edge: into a zero accumulator K19
    gives K1's output bitwise (the same loop in the same edge order)."""
    indptr, cols, vals = markov_csr(3000, 4, 2000)
    x = torch.randn((3000, 256), device=cuda_device).to(dtype)
    csr = CsrMatrix.from_numpy(indptr, cols, vals, cuda_device)
    deg = np.diff(indptr)
    rows = np.nonzero(deg)[0].astype(np.int32)
    compact = np.zeros(rows.shape[0] + 1, dtype=np.int64)
    np.cumsum(deg[rows], out=compact[1:])
    acc = torch.zeros((3000, 256), device=cuda_device)
    spmm_acc(acc, torch.from_numpy(rows).to(cuda_device),
             torch.from_numpy(compact).to(cuda_device), csr.indices,
             csr.vals, x)
    torch.cuda.synchronize()
    assert torch.equal(acc, spmm(csr, x))


@cuda
def test_k19_empty_round_launches_nothing(cuda_device):
    acc = torch.randn((10, 8), device=cuda_device)
    before = acc.clone()
    n0 = kernels.LAUNCHES["spmm_acc"]
    empty = [torch.zeros(0, dtype=torch.int32, device=cuda_device),
             torch.zeros(1, dtype=torch.int64, device=cuda_device),
             torch.zeros(0, dtype=torch.int32, device=cuda_device),
             torch.zeros(0, device=cuda_device)]
    assert spmm_acc(acc, *empty, torch.randn((4, 8), device=cuda_device)) \
        is acc
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmm_acc"] == n0 and torch.equal(acc, before)


def test_k19_wrapper_rejects_bad_operands():
    arrays = [torch.from_numpy(a) for a in _round_arrays(30, 7, 0, 9)]
    acc, table = torch.zeros((30, 4)), torch.zeros((7, 4))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.spmm_acc_(acc, *arrays, table)
    with pytest.raises(ValueError, match="acc must be a 2-D float32"):
        kernels.spmm_acc_(acc.double(), *arrays, table)
    with pytest.raises(ValueError, match="row_ids must be int32"):
        kernels.spmm_acc_(acc, arrays[0].long(), *arrays[1:], table)
    with pytest.raises(ValueError, match="acc's width"):
        kernels.spmm_acc_(acc, *arrays, torch.zeros((7, 5)))
    with pytest.raises(ValueError, match="indptr int64"):
        kernels.spmm_acc_(acc, arrays[0], arrays[1].int(), *arrays[2:],
                          table)
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_k16_wrapper_rejects_bad_operands():
    x = torch.zeros((5, 4))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.halo_pack(x, idx)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.halo_pack(x.double(), idx)
    with pytest.raises(ValueError, match="int32"):
        kernels.halo_pack(x, idx.long())
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


@cuda
@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("seed,base", [(0, 0), (2**40 + 3, 2**33 + 5)])
def test_k17_matches_k8_and_plain(cuda_device, world, seed, base):
    """The owner-routed first-order hop over ``world`` rank slices, their
    shares summed in this process: bitwise K8's walks and the plain
    version's on the CPU."""
    n, length = 3000, 20
    arrays = walk_csr(n, 1)
    t = WalkTables(*arrays, n, cuda_device)
    starts = torch.randint(0, n + 1, (4099,), dtype=torch.int32)
    slices = [ShardedWalkTables(*arrays, n, r, world, cuda_device)
              for r in range(world)]
    before = kernels.LAUNCHES["walk_owned"]
    got = walk_uniform_sharded(slices, starts.to(cuda_device), length, seed,
                               base)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["walk_owned"] == before + world * (length - 1)
    assert torch.equal(got, kernels.walk_uniform(
        t.indptr, t.cols, t.deg, starts.to(cuda_device), length, seed, base,
        n))
    cpu = [ShardedWalkTables(*arrays, n, r, world, "cpu")
           for r in range(world)]
    assert torch.equal(got.cpu(), walk_uniform_sharded(cpu, starts, length,
                                                       seed, base))


@cuda
@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("p,q", [(0.5, 2.0), (4.0, 0.25), (1.0, 100.0)])
def test_k18_matches_k12_and_plain(cuda_device, world, p, q):
    """The owner-routed p/q walk (K18's five stages) over ``world`` rank
    slices, their shares summed in this process: bitwise K12's walks and
    the plain stages' on the CPU."""
    n = 4000
    arrays = weighted_walk_csr(n, 2)
    t = WalkTables2(*arrays[:3], n, *arrays[3:], cuda_device)
    starts = torch.randint(0, n + 1, (1500,), dtype=torch.int32)
    starts[0] = 1  # the hub
    args = (10, float(np.float32(1.0 / p)), float(np.float32(1.0 / q)),
            walk2_tries(q), 2**40 + 7, 3)
    slices = [ShardedWalkTables(*arrays[:3], n, r, world, cuda_device,
                                *arrays[3:]) for r in range(world)]
    before = kernels.LAUNCHES["walk2_owned"]
    got = walk_p_q_sharded(slices, starts.to(cuda_device), *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["walk2_owned"] > before
    assert torch.equal(got, kernels.walk_p_q(
        t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum,
        starts.to(cuda_device), *args, n))
    cpu = [ShardedWalkTables(*arrays[:3], n, r, world, "cpu", *arrays[3:])
           for r in range(world)]
    assert torch.equal(got.cpu(), walk_p_q_sharded(cpu, starts, *args))


def test_k17_and_k18_wrappers_reject_bad_operands():
    n = 50
    arrays = weighted_walk_csr(n, 3, hub_degree=10)
    t = ShardedWalkTables(*arrays[:3], n, 0, 2, "cpu", *arrays[3:])
    cur = torch.zeros(7, dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.walk_owned(t.indptr, t.cols, t.deg, cur, 0, 0, 0, n, 0, True,
                           torch.empty_like(cur))
    with pytest.raises(ValueError, match="int32"):
        kernels.walk_owned(t.indptr, t.cols, t.deg, cur.long(), 0, 0, 0, n,
                           0, True, torch.empty_like(cur))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.walk2_stats(t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum,
                            cur, cur, n, 0, 1.0,
                            torch.empty((4, 7), dtype=torch.int32))
    with pytest.raises(ValueError, match="4 x 7"):
        kernels.walk2_stats(t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum,
                            cur, cur, n, 0, 1.0,
                            torch.empty((3, 7), dtype=torch.int32))
    with pytest.raises(ValueError, match="int64"):
        kernels.walk2_decide(torch.zeros((4, 7), dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32),
                             torch.zeros((2, 2), dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32), cur, 0, 0, 4,
                             0, 0, n, 1.0, torch.empty_like(cur))
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)
