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
float32 operations and the same logf).
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
from cleora_tpu_torch.ops.dense import (
    dense_markov,
    dense_markov_plain,
    log_clip,
    log_clip_plain,
)
from cleora_tpu_torch.ops.spmm import (
    CsrMatrix,
    spmm,
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


# ------------------------------------------- argument checks (need no card)
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
