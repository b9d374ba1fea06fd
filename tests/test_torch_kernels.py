"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every comparison here carries the ``cuda``
marker and skips without a card; the wrappers' argument checks need none
and run everywhere.  The file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels.py

Tolerances: K1 float32 rtol=1e-5, atol=1e-6 (the same float32 products,
summed in another order by the plain version's atomics); bf16 x atol=1e-2;
K2 atol=1e-6, and K2 after K1 bitwise K1 with the normalisation fused
(the same layout and roundings up to 1,024 columns); K3 bitwise (integer arithmetic, exact conversions); K4
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
about 7e-6 relative on a row of 5,000 edges); K15 bitwise, its packed
bits too (the same Philox words, comparisons and true divisions); the GCN SpMM's backward (K1 over
Âᵀ) rtol=1e-5, atol=1e-6, as K1; K16 bitwise (a copy); K1 with a
separate residual operand as K1; K17 and K18 bitwise (K8's and K12's
arithmetic on each rank's rows, K18's hop through K12's own device code;
one nonzero term per summed lane), K18's stages bitwise their plain
versions; K19
rtol=1e-5, atol=1e-6 in float32 and bfloat16 in each mode (add over
compact rows, write, and the last round's residual mix and normalisation;
exact bf16→float32 loads; the row sum in another order than the plain
version's atomics, the mix contracted), and one shard's round 0 with the
residual and the normalisation bitwise K1 with them fused (K1's loop,
slices and epilogue, in K1's order);
K1 with the l2/l1 normalisation in its epilogue, with hub rows cut into
slices, and the fused attention pass rtol=1e-5, atol=1e-6 against
spmm_plain / K4's plain weights followed by the plain normalisation (the
row sums and the online softmax in another order than the plain
version's), the hub rows (more than LONG_SLICE entries, left-Markov
values) at the same tolerance against a float64 reference, bf16 x
atol=1e-2 as K1; a shard's rows bitwise the whole matrix's (each row's
cut depends on its own degree).
"""

import numpy as np
import pytest
import torch

from cleora_tpu_torch import kernels
from cleora_tpu_torch.graph.hashing import init_embeddings
from cleora_tpu_torch.ops.attention import (
    attention_spmm,
    attention_spmm_plain,
    attention_step,
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
    normalize_plain,
)
from cleora_tpu_torch.algorithms import _GRAREP_FLOOR, _GRAREP_OFFSET
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
from cleora_tpu_torch.parallel.embed import overlap_views
from cleora_tpu_torch.parallel.shard import RoundCsr
from cleora_tpu_torch.ops.spmm import (
    CsrMatrix,
    spmm,
    spmm_acc,
    spmm_acc_plain,
    spmm_accumulate_,
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


def hub_rows_float64(csr, x, rows, temperature=None, norm="none"):
    """A float64 reference on ``rows``, one row at a time: K1's ``A @ x``
    (``temperature`` None) or the fused pass's propagate (JAX's masked
    softmax, reweighting and renormalisation, then the weighted sum),
    then the row normalisation ``norm``."""
    return hub_rows_and_magnitudes(csr, x, rows, temperature, norm)[0]


def hub_rows_and_magnitudes(csr, x, rows, temperature=None, norm="none"):
    """:func:`hub_rows_float64`, and each unnormalised element's sum of
    |term| (for the float32 bound of a sum taken in one sequence)."""
    xd = x.double()
    out, mag = [], []
    for r in rows.tolist():
        lo, hi = int(csr.indptr[r]), int(csr.indptr[r + 1])
        xc = xd.index_select(0, csr.indices[lo:hi].long())
        v = csr.vals[lo:hi].double()
        if temperature is not None:
            xr = xd[r] / xd[r].norm().clamp_min(1e-10)
            s = (xc @ xr) / xc.norm(dim=1).clamp_min(1e-10) / temperature
            valid = v != 0
            top = s[valid].max() if bool(valid.any()) else 0.0
            p = torch.where(valid, torch.exp(s - top), 0.0)
            v = p / p.sum().clamp_min(1e-10) * v
            v = v / v.sum().clamp_min(1e-10)
        y = v @ xc
        if norm == "l2":
            y = y / y.norm().clamp_min(1e-10)
        elif norm == "l1":
            y = y / y.abs().sum().clamp_min(1e-10)
        out.append(y)
        mag.append(v.abs() @ xc.abs())
    return torch.stack(out), torch.stack(mag)


def assert_rows_close(got, want, hub, ref):
    """K1 or the fused pass at rtol=1e-5, atol=1e-6: every row but the hubs
    (more than kernels.LONG_SLICE entries) against the plain version, the
    hubs against their float64 reference ``ref`` (the plain version's
    float32 atomics add a hub's thousands of terms in an order of their
    own, further from the exact sum than the kernel's slices)."""
    hub = torch.from_numpy(np.asarray(hub)).to(got.device)
    torch.testing.assert_close(got[~hub], want[~hub], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[torch.nonzero(hub).flatten()].double(),
                               ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [8, 64, 256, 300, 7, 1024])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [0.0, 0.3])
@pytest.mark.parametrize("norm", ["l2", "l1"])
@cuda
def test_k1_fused_normalisation_matches_plain(cuda_device, d, x_dtype, w,
                                              norm):
    indptr, cols, vals = markov_csr(3000, d, 5000)
    vals[indptr[2]:indptr[3]] = 0.0  # a row whose values are all 0
    csr = CsrMatrix.from_numpy(indptr, cols, vals, cuda_device)
    x = torch.randn((3000, d), device=cuda_device).to(x_dtype)
    before = dict(kernels.LAUNCHES)
    out = spmm(csr, x, w, normalization=norm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmm_csr"] == before["spmm_csr"] + 1
    assert kernels.LAUNCHES["row_normalize"] == before["row_normalize"]
    tol = ({"rtol": 1e-5, "atol": 1e-6} if x_dtype == torch.float32
           else {"rtol": 0.0, "atol": 1e-2})
    torch.testing.assert_close(
        out, normalize_plain(spmm_plain(csr, x, w), norm), **tol)
    if w == 0.0:
        assert torch.all(out[2] == 0.0)


@pytest.mark.parametrize("d", [8, 64, 256, 300, 7, 1024])
@pytest.mark.parametrize("norm", ["l2", "l1"])
@cuda
def test_k2_after_k1_is_k1_fused_bitwise(cuda_device, d, norm):
    """Up to 1,024 columns K2 takes K1's epilogue layout and roundings:
    K1 then K2 (halo="overlap": K19's sums then K2) gives K1 with the
    normalisation fused, bit for bit."""
    csr = CsrMatrix.from_numpy(*markov_csr(3000, d, 5000), cuda_device)
    x = torch.randn((3000, d), device=cuda_device)
    fused = spmm(csr, x, normalization=norm)
    torch.cuda.synchronize()
    assert torch.equal(normalize(spmm(csr, x), norm), fused)


@cuda
def test_k1_wide_rows_normalise_by_k2(cuda_device):
    csr = CsrMatrix.from_numpy(*markov_csr(500, 3, 300), cuda_device)
    x = torch.randn((500, 1028), device=cuda_device)
    with pytest.raises(ValueError, match="not normalised"):
        kernels.spmm_csr(csr.indptr, csr.indices, csr.vals, x,
                         normalization="l2")
    before = dict(kernels.LAUNCHES)
    out = spmm(csr, x, normalization="l2")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmm_csr"] == before["spmm_csr"] + 1
    assert kernels.LAUNCHES["row_normalize"] == before["row_normalize"] + 1
    torch.testing.assert_close(
        out, l2_normalize_plain(spmm_plain(csr, x)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [8, 256, 7, 4096])
@pytest.mark.parametrize("norm", ["none", "l2"])
@cuda
def test_k1_hub_slices_match_plain(cuda_device, d, norm):
    """A hub of 50,000 entries (13 slices) and one of 4,097 (2 slices),
    with and without the hub plan.  Without it (every row its own team,
    a comparison, never a path) a hub is one float32 sum taken in one
    sequence: it is held to that sum's bound, (n - 1) 2^-24 sum |term|
    (Higham), and the epilogue to the plain normalisation of that sum."""
    if d > kernels.FUSED_NORM_MAX_WIDTH and norm != "none":
        pytest.skip("K1 normalises rows of at most 1,024 columns")
    indptr, cols, vals = markov_csr(6000, 11, 50_000)
    deg = np.diff(indptr)
    deg[5] = 4097
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    rng = np.random.default_rng(d)
    cols = rng.integers(0, 6000, size=int(indptr[-1]))
    vals = ((1.0 / np.maximum(deg, 1))[np.repeat(np.arange(6000), deg)]
            .astype(np.float32))
    csr = CsrMatrix.from_numpy(indptr, cols, vals, cuda_device)
    hubs = csr.hub_plan()
    assert hubs.item_rows.tolist() == [1] * 13 + [5] * 2
    x = torch.randn((6000, d), device=cuda_device)
    want = normalize_plain(spmm_plain(csr, x), norm)
    hub = deg > kernels.LONG_SLICE
    ids = torch.from_numpy(np.flatnonzero(hub))
    ref = hub_rows_float64(csr, x, ids, norm=norm)
    out = kernels.spmm_csr(csr.indptr, csr.indices, csr.vals, x, 0.0, None,
                           norm, hubs)
    torch.cuda.synchronize()
    assert_rows_close(out, want, hub, ref)
    whole = kernels.spmm_csr(csr.indptr, csr.indices, csr.vals, x, 0.0,
                             None, norm, None)
    raw = kernels.spmm_csr(csr.indptr, csr.indices, csr.vals, x, 0.0, None,
                           "none", None)
    torch.cuda.synchronize()
    rest = torch.from_numpy(~hub).to(cuda_device)
    torch.testing.assert_close(whole[rest], want[rest], rtol=1e-5, atol=1e-6)
    raw_ref, mag = hub_rows_and_magnitudes(csr, x, ids)
    bound = torch.from_numpy(deg[hub] - 1).to(mag)[:, None] * 2.0**-24 * mag
    assert bool(((raw[ids.to(cuda_device)].double() - raw_ref).abs()
                 <= bound).all())
    torch.testing.assert_close(whole, normalize_plain(raw, norm), rtol=1e-5,
                               atol=1e-6)


@cuda
def test_k1_shard_rows_are_bitwise_the_whole(cuda_device):
    """Rows [1, 4000) as a CSR of their own (the hub among them) give the
    whole matrix's rows bitwise: each row is cut by its own degree."""
    indptr, cols, vals = markov_csr(6000, 12, 20_000)
    csr = CsrMatrix.from_numpy(indptr, cols, vals, cuda_device)
    lo, hi = 1, 4000
    part = CsrMatrix(  # its columns index the whole matrix's rows
        torch.from_numpy(indptr[lo:hi + 1] - indptr[lo]).to(cuda_device),
        csr.indices[indptr[lo]:indptr[hi]], csr.vals[indptr[lo]:indptr[hi]])
    x = torch.randn((6000, 256), device=cuda_device)
    for norm in ("none", "l2"):
        whole = spmm(csr, x, normalization=norm)
        mine = kernels.spmm_csr(part.indptr, part.indices, part.vals, x, 0.0,
                                None, norm, part.hub_plan())
        torch.cuda.synchronize()
        assert torch.equal(mine, whole[lo:hi])


@pytest.mark.parametrize("d", [8, 256, 300, 7, 1024])
@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("norm", ["none", "l2", "l1"])
@cuda
def test_attention_spmm_matches_plain(cuda_device, d, temperature, norm):
    indptr, cols, vals = markov_csr(3000, d, 5000)  # the hub: 2 slices
    vals[indptr[2]:indptr[3]] = 0.0  # a row whose values are all 0
    vals[::13] = 0.0
    csr = CsrMatrix.from_numpy(indptr, cols, vals, cuda_device)
    x = torch.randn((3000, d), device=cuda_device)
    before = kernels.LAUNCHES["attention_spmm"]
    out = attention_spmm(csr, x, temperature, norm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention_spmm"] == before + 1
    want = attention_spmm_plain(csr, x, temperature, norm)
    hub = np.diff(indptr) > kernels.LONG_SLICE
    ref = hub_rows_float64(csr, x, torch.from_numpy(np.flatnonzero(hub)),
                           temperature, norm)
    assert_rows_close(out, want, hub, ref)
    assert torch.all(out[2] == 0.0) and torch.all(out[0] == 0.0)
    whole = kernels.attention_spmm(csr.indptr, csr.indices, csr.vals, x,
                                   temperature, norm, None)
    torch.cuda.synchronize()
    assert_rows_close(whole, want, hub, ref)


@cuda
def test_attention_step_launches_only_the_fused_pass(cuda_device):
    csr = CsrMatrix.from_numpy(*markov_csr(3000, 5, 500), cuda_device)
    x = torch.randn((3000, 64), device=cuda_device)
    kernels.reset_launches()
    y = attention_step(csr, x, 0.7, "l2", False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0) | {
        "attention_spmm": 1}
    torch.testing.assert_close(y, attention_spmm_plain(csr, x, 0.7, "l2"),
                               rtol=1e-5, atol=1e-6)


def test_attention_spmm_wrapper_rejects_bad_operands():
    csr = CsrMatrix.from_numpy(*markov_csr(50, 1, 10), torch.device("cpu"))
    x = torch.randn((50, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.attention_spmm(csr.indptr, csr.indices, csr.vals, x, 1.0)


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
    got = kernels.run_length(keys, n, passes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["run_length"] == before + 1
    want = cooccur.run_length_plain(keys, None, n, passes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # a merge of two overlapping halves of partition 0's runs (a merge
    # joins ranges of one partition, each sorted by (cen, ctx))
    m0 = int(got[3][0])
    cen, ctx, cnt = (t[:m0] for t in got[:3])
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
    # on a graph of nh nodes: rows over LONG_SLICE entries (node 1, and
    # node nh - 1 at the range's end), and an empty range
    nh = 2 * kernels.LONG_SLICE
    hub = kernels.LONG_SLICE + 300
    cen_h = torch.tensor([1] * hub + [7] * 3 + [nh - 1] * (nh - 8),
                         dtype=torch.int32, device=cuda_device)
    ctx_h = torch.cat([torch.randperm(nh, device=cuda_device)[:k].sort().values
                       for k in (hub, 3, nh - 8)]).int()
    cnt_h = torch.randint(1, 1000, cen_h.shape, dtype=torch.int32,
                          device=cuda_device)
    col_h = torch.randint(1, 10**6, (nh,), device=cuda_device)
    total_h = torch.tensor([10**9], device=cuda_device)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    cases = ([(*r[:3], col, total, n) for r in ranges]
             + [(cen_h, ctx_h, cnt_h, col_h, total_h, nh),
                (empty, empty, empty, col, total, n)])
    for cen, ctx, cnt, c, t, nn in cases:
        before = kernels.LAUNCHES["ppmi"]
        vals, indptr = kernels.ppmi(cen, ctx, cnt, c, t, nn)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["ppmi"] == before + (cen.numel() > 0)
        want_vals, want_indptr = cooccur.ppmi_values_plain(cen, ctx, cnt, c,
                                                           t, nn)
        assert torch.equal(indptr, want_indptr)
        torch.testing.assert_close(vals, want_vals, rtol=1e-6, atol=0.0)
    with pytest.raises(ValueError, match="cen must be non-decreasing"):
        kernels.ppmi(cen_h.flip(0).contiguous(), ctx_h, cnt_h, col_h,
                     total_h, nh)


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


def _sorted_keys(rng, n, passes, runs, long_run, dead):
    """Ascending int64 sweep keys: ``runs`` random runs of 1-40 keys, one
    run of ``long_run`` keys (many tiles of 2,048), ``dead`` INT64_MAX."""
    pairs = np.unique(rng.integers(0, n * n, size=runs))
    cen, ctx = pairs // n, pairs % n
    keys = ((cen % passes) * n + cen) * n + ctx
    reps = rng.integers(1, 41, size=keys.shape[0])
    reps[keys.shape[0] // 2] = long_run
    keys = np.sort(np.repeat(keys, reps))
    return np.concatenate([keys, np.full(dead, np.iinfo(np.int64).max)])


@cuda
@pytest.mark.parametrize("case", ["runs", "long_run", "all_dead", "one_key",
                                  "unaligned"])
@pytest.mark.parametrize("passes", [1, 3])
def test_k10_sweep_bitwise(cuda_device, case, passes):
    """The sweep form against its plain version: runs that cross tiles,
    one run over many tiles, a stream of dead keys only, a single key, and
    keys that are not 16-byte aligned (the scalar loads)."""
    rng = np.random.default_rng(passes)
    n = 1000
    keys = {"runs": lambda: _sorted_keys(rng, n, passes, 20000, 3, 777),
            "long_run": lambda: _sorted_keys(rng, n, passes, 3000, 50000, 0),
            "all_dead": lambda: np.full(5000, np.iinfo(np.int64).max),
            "one_key": lambda: np.array([(passes - 1) * n * n + 7]),
            "unaligned": lambda: _sorted_keys(rng, n, passes, 5000, 3, 5),
            }[case]()
    k = torch.from_numpy(keys).to(cuda_device)
    if case == "unaligned":
        k = torch.cat([k[:1], k])[1:]
    before = kernels.LAUNCHES["run_length"]
    got = kernels.run_length(k, n, passes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["run_length"] == before + 1
    want = cooccur.run_length_plain(k, None, n, passes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _count_range(rng, n, m, device, lo=1, hi=50):
    pairs = np.unique(rng.integers(0, n * n, size=m))
    put = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
    return (put(pairs // n), put(pairs % n),
            put(rng.integers(lo, hi, size=pairs.shape[0])), pairs.shape[0])


@cuda
@pytest.mark.parametrize("case", ["disjoint", "identical", "interleaved",
                                  "empty_a", "empty_b", "wrap", "tiles"])
def test_k10_merge_bitwise(cuda_device, case, monkeypatch):
    """The merge form against its plain version (a sort of the
    concatenation and the sweep form), without a sort: disjoint ranges,
    identical ranges, interleaved ranges, an empty a or b, counts that wrap
    past 2^31, and ranges of many tiles whose common pairs fall on tile
    boundaries."""
    rng = np.random.default_rng(11)
    n = 3000
    dev = cuda_device
    a = _count_range(rng, n, 20000, dev)
    if case == "disjoint":
        b = _count_range(rng, n, 20000, dev)
        b = (b[0] + n, b[1], b[2], b[3])  # rows past a's
        n = 2 * n
    elif case in ("identical", "wrap"):
        b = tuple(t.clone() if torch.is_tensor(t) else t for t in a)
        if case == "wrap":
            a = (a[0], a[1], torch.full_like(a[2], 2**31 - 5), a[3])
    elif case == "interleaved":
        b = _count_range(rng, n, 30000, dev)
    elif case == "empty_a":
        a, b = tuple(t[:0] if torch.is_tensor(t) else 0 for t in a), a
    elif case == "empty_b":
        b = tuple(t[:0] if torch.is_tensor(t) else 0 for t in a)
    else:  # every 1,023rd entry of a again in b: pairs on tile boundaries
        a = _count_range(rng, n, 400000, dev)
        pick = torch.arange(0, a[3], 1023, device=dev)
        b = (a[0][pick], a[1][pick], a[2][pick] + 1, int(pick.shape[0]))

    def no_sort(*args, **kw):
        raise AssertionError("the merge form ran torch.sort")

    before = kernels.LAUNCHES["run_length_merge"]
    with monkeypatch.context() as m:
        m.setattr(torch, "sort", no_sort)
        got = cooccur._merge(a, b, n)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["run_length_merge"] == before + 1
    want = cooccur.merge_plain(a, b, n)
    assert got[3] == want[3]
    for x, y in zip(got[:3], want[:3]):
        assert torch.equal(x, y)


def _long_row_piece(n, rows, degree, hub, seed, device):
    """A PPMI piece's shape: ``rows`` non-empty rows of ``n`` (the rest
    empty), each with ascending random columns, one hub row of ``hub``
    entries; left-Markov values (a row sums to 1)."""
    rng = np.random.default_rng(seed)
    full = np.sort(rng.choice(n, size=rows, replace=False))
    deg = np.zeros(n, dtype=np.int64)
    deg[full] = rng.integers(degree // 2, 2 * degree, size=rows)
    deg[full[rows // 2]] = hub
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = np.concatenate([np.sort(rng.integers(0, n, size=k))
                           for k in deg if k])
    vals = rng.random(cols.shape[0]).astype(np.float32)
    sums = np.add.reduceat(vals, indptr[:-1][deg > 0])
    vals /= np.repeat(sums, deg[deg > 0]).astype(np.float32)
    return CsrMatrix.from_numpy(indptr, cols, vals, device)


@cuda
@pytest.mark.parametrize("d", [272, 256, 300, 302])
@pytest.mark.parametrize("band_bytes", [None, 1 << 20])
@pytest.mark.parametrize("hub", [10_000, 100_000])
@pytest.mark.parametrize("cut", [None, 300])
def test_k5_long_rows_match_plain(cuda_device, d, band_bytes, hub, cut,
                                  monkeypatch):
    """K5's long-row path (a warp a slice of a row, L2-sized bands of x; at
    d=302 its scalar form) against its plain version: a piece of 8,000
    rows of which 1,000 hold about 200 entries and one a hub, through the
    row plan (acc only, the empty rows untouched), and the short-row
    kernel over the same rows through the full call (out and acc, every
    row).  ``band_bytes`` cuts x into many bands; ``cut`` slices of 300
    entries cut the hub and many other rows (the slices' sums joined)."""
    if band_bytes is not None:
        monkeypatch.setattr(kernels, "BAND_BYTES", band_bytes)
    if cut is not None:
        monkeypatch.setattr(kernels, "LONG_SLICE", cut)
    n = 8000
    csr = _long_row_piece(n, 1000, 200, hub, d, cuda_device)
    plan = csr.row_plan()
    assert plan is not None and plan.rows.shape[0] == 1000
    assert plan.split.shape[0] > (100 if cut else 0)
    x = torch.randn((n, d), device=cuda_device)
    acc = torch.randn((n, d), device=cuda_device)
    want = acc.clone()
    before = kernels.LAUNCHES["spmm_axpy"]
    spmm_accumulate_(csr, x, acc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmm_axpy"] == before + 1
    spmm_axpy_plain(csr, x, 1.0, acc=want, d=1.0)
    torch.testing.assert_close(acc, want, rtol=1e-5, atol=1e-6)
    empty = torch.ones(n, dtype=torch.bool, device=cuda_device)
    empty[plan.rows.long()] = False
    z, acc2 = (torch.randn((n, d), device=cuda_device) for _ in range(2))
    want2 = acc2.clone()
    out = spmm_axpy(csr, x, -2.0, 2.0, z=z, c=-1.0, acc=acc2, d=0.05)
    torch.cuda.synchronize()
    ref = spmm_axpy_plain(csr, x, -2.0, 2.0, z=z, c=-1.0, acc=want2, d=0.05)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(acc2, want2, rtol=1e-5, atol=1e-6)
    assert torch.equal(out[empty], ref[empty])


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
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


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
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


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
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


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
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


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
        kernels.run_length(keys, 4, 1)
    with pytest.raises(ValueError, match="int64"):
        kernels.run_length(keys.int(), 4, 1)
    with pytest.raises(ValueError, match="passes"):
        kernels.run_length(keys, 4, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ppmi_colsum_(i32, i32, torch.zeros(4, dtype=torch.int64),
                             torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        kernels.ppmi(i32, i32, i32, torch.zeros(4), torch.zeros(1), 4)
    with pytest.raises(ValueError, match="one 1-D shape"):
        kernels.ppmi(i32, i32, i32[:3], torch.zeros(4, dtype=torch.int64),
                     torch.zeros(1, dtype=torch.int64), 4)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


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
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


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
    """h, the packed bits and dz bitwise the plain versions' (odd shapes
    take the tail group's scalar path; (1001, 64) spans many tiles)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    z = torch.randn(shape, device=cuda_device, generator=gen)
    z[0, 0] = 0.0  # ReLU's gradient at 0 is 0
    dh = torch.randn(shape, device=cuda_device, generator=gen)
    before = kernels.LAUNCHES["relu_dropout"]
    before_bwd = kernels.LAUNCHES["relu_dropout_backward"]
    for epoch, layer, seed in ((0, 0, 42), (7, 1, 2**40 + 3), (199, 2, -1)):
        h, mask = relu_dropout(z, p, seed, epoch, layer)
        dz = relu_dropout_backward(mask, dh, p)
        torch.cuda.synchronize()
        h_plain, mask_plain = relu_dropout_plain(z, p, seed, epoch, layer)
        assert torch.equal(h, h_plain) and torch.equal(mask, mask_plain)
        assert torch.equal(dz, relu_dropout_backward_plain(mask, dh, p))
        # the same bits as on the CPU, whatever the device
        h_cpu, mask_cpu = relu_dropout_plain(z.cpu(), p, seed, epoch, layer)
        assert torch.equal(h.cpu(), h_cpu)
        assert torch.equal(mask.cpu(), mask_cpu)
    assert kernels.LAUNCHES["relu_dropout"] == before + 3
    assert kernels.LAUNCHES["relu_dropout_backward"] == before_bwd + 3
    # the vector loads need 16-byte boundaries: the wrappers refuse others
    off = torch.empty(z.numel() + 1, device=cuda_device)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        kernels.relu_dropout(off, p, 0, 0, 0)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.relu_dropout_backward(mask, off.view(shape), p)


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
    mask = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.relu_dropout_backward(mask, z, 0.5)
    with pytest.raises(ValueError, match="int32 words"):
        kernels.relu_dropout_backward(torch.zeros(2, dtype=torch.int32), z,
                                      0.5)
    with pytest.raises(ValueError, match="int32 words"):
        kernels.relu_dropout_backward(mask.long(), z, 0.5)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


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
    base = torch.randn((700 * d + offset,), device=cuda_device).to(dtype)
    table = base[offset:].view(700, d)
    res = torch.randn((3000, d), device=cuda_device).to(dtype)
    acc0 = torch.randn((3000, d), device=cuda_device)
    # a compact round (add), then views of every row: the first round
    # (write) and the last (add, residual mix, normalisation)
    rc = RoundCsr(*arrays)
    full = overlap_views([rc, rc], 3000, cuda_device)[0][:4]
    compact = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    hubs = kernels.hub_plan(compact[1])
    assert hubs.item_rows.numel() > 0  # row 3 is cut into slices
    modes = [(compact, {}, kernels.hub_plan(compact[1])),
             (full, dict(write=True), kernels.hub_plan(full[1])),
             (full, dict(residual_weight=0.3, residual=res,
                         normalization="l2" if d <= 1024 else "none"),
              kernels.hub_plan(full[1]))]
    for args, kw, hubs in modes:
        before = kernels.LAUNCHES["spmm_acc"]
        got = spmm_acc(acc0.clone(), *args, table, hubs=hubs, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["spmm_acc"] == before + 1
        want = spmm_acc_plain(acc0.clone(), *args, table, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    got = spmm_acc(acc0.clone(), *compact, table, hubs=modes[0][2])
    untouched = torch.ones(3000, dtype=torch.bool, device=cuda_device)
    untouched[compact[0].long()] = False
    assert torch.equal(got[untouched], acc0[untouched])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,norm", [(0.0, "l2"), (0.3, "l1"), (0.3, "none")])
@cuda
def test_k19_over_every_edge_is_k1(cuda_device, dtype, w, norm):
    """Round 0 of one shard holds every edge and is its last round: the
    step is one K19 launch, bitwise K1 with the residual mix and the
    normalisation fused (the same loop, slices and epilogue in K1's
    order), on a graph with a row over LONG_SLICE entries."""
    indptr, cols, vals = markov_csr(3000, 4, kernels.LONG_SLICE + 2000)
    x = torch.randn((3000, 256), device=cuda_device).to(dtype)
    csr = CsrMatrix.from_numpy(indptr, cols, vals, cuda_device)
    rc = RoundCsr.from_edges(np.repeat(np.arange(3000), np.diff(indptr)),
                             cols, vals)
    (view,) = overlap_views([rc], 3000, cuda_device)
    assert view[4].item_rows.numel() == 2  # the hub's slices
    acc = torch.full((3000, 256), float("nan"), device=cuda_device)
    before = dict(kernels.LAUNCHES)
    spmm_acc(acc, *view[:4], x, write=True, residual_weight=w, residual=x,
             normalization=norm, hubs=view[4])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before | {
        "spmm_acc": before["spmm_acc"] + 1}
    assert torch.equal(acc, spmm(csr, x, w, normalization=norm))


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
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


def test_k19_wrapper_rejects_bad_modes():
    arrays = [torch.from_numpy(a) for a in _round_arrays(30, 7, 0, 9)]
    acc, table = torch.zeros((30, 4)), torch.zeros((7, 4))
    kernels.reset_launches()
    for kw in (dict(write=True), dict(normalization="l1")):
        with pytest.raises(ValueError, match="need a view of every row"):
            kernels.spmm_acc_(acc, *arrays, table, **kw)
    with pytest.raises(ValueError, match="must list every row of acc"):
        kernels.spmm_acc_(acc, None, *arrays[1:], table)
    with pytest.raises(ValueError, match="residual must be acc's shape"):
        kernels.spmm_acc_(torch.zeros((10, 4)), None, *arrays[1:], table,
                          residual_weight=0.5)
    with pytest.raises(ValueError, match="not normalised in the epilogue"):
        kernels.spmm_acc_(torch.zeros((10, 1028)), None, arrays[1],
                          *arrays[2:], torch.zeros((7, 1028)),
                          normalization="l2")
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


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
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


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
    """The owner-routed p/q walk (K18's local stage and, past one slice,
    its chunked cross-owner rounds) over ``world`` rank slices, their
    shares summed in this process: bitwise K12's walks and the plain
    stages' on the CPU.  One slice launches one local stage a hop."""
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
    launches = kernels.LAUNCHES["walk2_owned"] - before
    assert launches == 9 if world == 1 else launches > 9 * world
    assert torch.equal(got, kernels.walk_p_q(
        t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum,
        starts.to(cuda_device), *args, n))
    cpu = [ShardedWalkTables(*arrays[:3], n, r, world, "cpu", *arrays[3:])
           for r in range(world)]
    assert torch.equal(got.cpu(), walk_p_q_sharded(cpu, starts, *args))


@cuda
@pytest.mark.parametrize("chunk", [1, 8, 32])
def test_k18_stages_match_plain(cuda_device, chunk):
    """K18's four stages one by one against their plain versions on the
    same inputs, at hop 3 of walks over 2 slices with 13 tries (the chunk
    from round 8 holds the forced last round)."""
    from cleora_tpu_torch.ops import walk as walk_ops

    n = 4000
    arrays = weighted_walk_csr(n, 4)
    slices = [ShardedWalkTables(*arrays[:3], n, r, 2, cuda_device,
                                *arrays[3:]) for r in range(2)]
    starts = torch.randint(0, n, (3000,), dtype=torch.int32,
                           device=cuda_device)
    inv_p, inv_q, tries, seed, base = 2.0, 0.01, 13, 9, 11
    walks = walk_p_q_sharded(slices, starts, 5, inv_p, inv_q, tries, seed,
                             base)
    prev, cur = walks[:, 2].contiguous(), walks[:, 3].contiguous()
    buf = torch.zeros((4, starts.shape[0]), dtype=torch.int32,
                      device=cuda_device)
    for t in slices:
        out = torch.empty_like(buf)
        got = kernels.walk2_local(t.indptr, t.cols, t.vals, t.deg, t.wmax,
                                  t.wsum, cur, prev, 3, seed, base, n,
                                  t.row_lo, inv_p, inv_q, tries, out)
        assert torch.equal(got, walk_ops.walk2_local_plain(
            t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum, cur, prev, 3,
            seed, base, n, t.row_lo, inv_p, inv_q, tries))
        buf += got
    stats = buf[1:]
    lanes = torch.nonzero((buf[0] == 0) & (cur < n)).squeeze(1).int()
    assert lanes.numel() > 100
    for r0 in (0, 8):
        r0 -= r0 % chunk
        count = lanes.shape[0]
        prop = torch.zeros((2, count * chunk), dtype=torch.int32,
                           device=cuda_device)
        member = torch.zeros((count,), dtype=torch.int32, device=cuda_device)
        for t in slices:
            got = kernels.walk2_propose(
                t.indptr, t.cols, t.vals, stats, lanes, cur, prev, 3, r0,
                chunk, tries, seed, base, n, t.row_lo, inv_q,
                torch.empty_like(prop))
            assert torch.equal(got, walk_ops.walk2_propose_plain(
                t.indptr, t.cols, t.vals, stats, lanes, cur, prev, 3, r0,
                chunk, tries, seed, base, n, t.row_lo, inv_q))
            prop += got
        for t in slices:
            got = kernels.walk2_member(
                t.indptr, t.cols, t.deg, stats, lanes, prop, prev, 3, r0,
                chunk, tries, seed, base, n, t.row_lo, inv_q,
                torch.empty_like(member))
            assert torch.equal(got, walk_ops.walk2_member_plain(
                t.indptr, t.cols, t.deg, stats, lanes, prop, prev, 3, r0,
                chunk, tries, seed, base, n, t.row_lo, inv_q))
            member += got
        nxt = torch.full_like(cur, -7)
        nxt_plain = nxt.clone()
        still = kernels.walk2_decide(stats, lanes, prop, member, prev, 3, r0,
                                     chunk, tries, seed, base, n, inv_q, nxt)
        assert torch.equal(still, walk_ops.walk2_decide_plain(
            stats, lanes, prop, member, prev, 3, r0, chunk, tries, seed,
            base, n, inv_q, nxt_plain))
        assert torch.equal(nxt, nxt_plain)


def test_k17_and_k18_wrappers_reject_bad_operands():
    n = 50
    arrays = weighted_walk_csr(n, 3, hub_degree=10)
    t = ShardedWalkTables(*arrays[:3], n, 0, 2, "cpu", *arrays[3:])
    cur = torch.zeros(7, dtype=torch.int32)
    tables = (t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.walk_owned(t.indptr, t.cols, t.deg, cur, 0, 0, 0, n, 0, True,
                           torch.empty_like(cur))
    with pytest.raises(ValueError, match="int32"):
        kernels.walk_owned(t.indptr, t.cols, t.deg, cur.long(), 0, 0, 0, n,
                           0, True, torch.empty_like(cur))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.walk2_local(*tables, cur, cur, 0, 0, 0, n, 0, 1.0, 1.0, 64,
                            torch.empty((4, 7), dtype=torch.int32))
    with pytest.raises(ValueError, match="4 x 7"):
        kernels.walk2_local(*tables, cur, cur, 0, 0, 0, n, 0, 1.0, 1.0, 64,
                            torch.empty((3, 7), dtype=torch.int32))
    # a (B,) out only for a slice that holds every row
    with pytest.raises(ValueError, match="every row"):
        kernels.walk2_local(*tables, cur, cur, 0, 0, 0, n, 0, 1.0, 1.0, 64,
                            torch.empty(7, dtype=torch.int32))
    stats = torch.zeros((3, 7), dtype=torch.int32)
    lanes = torch.zeros(2, dtype=torch.int32)
    prop = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        kernels.walk2_decide(stats, lanes.long(), prop, lanes, cur, 0, 0, 8,
                             64, 0, 0, n, 1.0, torch.empty_like(cur))
    with pytest.raises(ValueError, match="power of two"):
        kernels.walk2_decide(stats, lanes, prop, lanes, cur, 0, 0, 6, 64, 0,
                             0, n, 1.0, torch.empty_like(cur))
    with pytest.raises(ValueError, match="below tries"):
        kernels.walk2_member(t.indptr, t.cols, t.deg, stats, lanes, prop,
                             cur, 0, 64, 8, 64, 0, 0, n, 0, 1.0,
                             torch.empty(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="2 x 16"):
        kernels.walk2_propose(t.indptr, t.cols, t.vals, stats, lanes, cur,
                              cur, 0, 0, 8, 64, 0, 0, n, 0, 1.0,
                              torch.empty((2, 8), dtype=torch.int32))
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)