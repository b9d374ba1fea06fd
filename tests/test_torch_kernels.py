"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips without a card.  The file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels.py

Tolerances: K1 float32 rtol=1e-5, atol=1e-6 (the same float32 products,
summed in another order by the plain version's atomics); bf16 x atol=1e-2;
K2 atol=1e-6; K3 bitwise (integer arithmetic, exact conversions); K4
rtol=1e-5, atol=1e-6 (dot products and row sums in another order).
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
from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm, spmm_plain

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("d", [8, 256, 300, 7])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [0.0, 0.3])
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
