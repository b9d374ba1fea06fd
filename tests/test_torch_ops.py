"""The port's ops against the JAX package's, on the CPU.

SpMM is compared with the JAX flat COO path and with its sliced-ELL path
(rtol=1e-5, atol=1e-6: float32 sums taken in another order); row
normalisation elementwise (atol=1e-6); spectral normalisation and whitening
through Gram matrices, because SVD/eigh column signs are arbitrary.  The
CUDA kernels against their plain versions: tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleora_tpu.ops.normalize import normalize as jax_normalize
from cleora_tpu.ops.normalize import spectral_normalize as jax_spectral
from cleora_tpu.ops.whiten import whiten as jax_whiten
from cleora_tpu.ops.spmm import spmm as jax_spmm
from cleora_tpu.ops.spmm_ell import plan_ell, spmm_ell
from cleora_tpu_torch import kernels
from cleora_tpu_torch.kernels import build
from cleora_tpu_torch.ops import memory
from cleora_tpu_torch.ops.normalize import (
    l1_normalize,
    l1_normalize_plain,
    l2_normalize,
    l2_normalize_plain,
    normalize,
    spectral_normalize,
)
from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm, spmm_plain
from cleora_tpu_torch.ops.whiten import whiten
from torch_test_support import one_torch_thread  # noqa: F401


def random_csr(n, seed, hub_degree=0, avg_degree=4):
    """Row-sorted COO + CSR with zero-degree rows and, optionally, one hub
    row (row 1) of ``hub_degree`` edges."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_degree, size=n)
    deg[::7] = 0
    if hub_degree:
        deg[1] = hub_degree
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.shape[0])
    vals = rng.random(rows.shape[0]).astype(np.float32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    return rows, cols, vals, indptr


def _csr(indptr, cols, vals):
    return CsrMatrix.from_numpy(indptr, cols, vals, torch.device("cpu"))


@pytest.mark.parametrize("d", [8, 33])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_spmm_plain_matches_jax_flat(d, x_dtype):
    n = 400
    rows, cols, vals, indptr = random_csr(n, seed=d)
    x = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    ref = np.asarray(jax_spmm(jnp.asarray(rows, jnp.int32),
                              jnp.asarray(cols, jnp.int32),
                              jnp.asarray(vals), jx, n))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    ours = spmm_plain(_csr(indptr, cols, vals), tx)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)
    # residual mix (1-w)·y + w·x, as ops/loop.py:_step computes it
    w = 0.3
    mixed = (1.0 - w) * jnp.asarray(ref) + w * jx.astype(jnp.float32)
    np.testing.assert_allclose(
        spmm_plain(_csr(indptr, cols, vals), tx, w).numpy(),
        np.asarray(mixed), rtol=1e-5, atol=1e-6)


def test_spmm_plain_matches_jax_ell():
    n, d = 600, 16
    rows, cols, vals, indptr = random_csr(n, seed=3, hub_degree=150)
    plan = plan_ell(rows, cols, vals, n)
    assert plan is not None and plan.hub is not None
    x = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    order, rank = np.asarray(plan.order), np.asarray(plan.rank)
    ref = np.asarray(spmm_ell(plan.device(), jnp.asarray(x[order])))[rank]
    ours = spmm_plain(_csr(indptr, cols, vals), torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_spmm_dispatches_to_plain_on_cpu():
    n = 200
    _, cols, vals, indptr = random_csr(n, seed=4)
    csr = _csr(indptr, cols, vals)
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((n, 8)).astype(np.float32))
    kernels.reset_launches()
    assert torch.equal(spmm(csr, x, 0.25), spmm_plain(csr, x, 0.25))
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


def test_csr_validation():
    indptr = np.array([0, 1, 2], dtype=np.int64)
    with pytest.raises(ValueError, match="out of range"):
        _csr(indptr, np.array([0, 2]), np.ones(2, np.float32))
    with pytest.raises(ValueError, match="malformed CSR"):
        _csr(np.array([0, 2, 1]), np.array([0, 1]), np.ones(2, np.float32))


def test_csr_from_coo_matches_from_numpy_and_validates():
    rows, cols, vals, indptr = random_csr(300, seed=8, hub_degree=40)
    a = CsrMatrix.from_coo(rows, cols, vals, 300, torch.device("cpu"))
    b = _csr(indptr, cols, vals)
    for name in ("indptr", "indices", "vals"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    # trailing empty rows and an empty matrix
    c = CsrMatrix.from_coo(rows, cols, vals, 320, torch.device("cpu"))
    assert c.n_rows == 320 and int(c.indptr[-1]) == rows.shape[0]
    empty = CsrMatrix.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                               np.zeros(0, np.float32), 5, torch.device("cpu"))
    assert empty.nnz == 0 and empty.n_rows == 5
    with pytest.raises(ValueError, match="rows must be sorted"):
        CsrMatrix.from_coo(rows[::-1], cols, vals, 300, torch.device("cpu"))
    with pytest.raises(ValueError, match="row index out of range"):
        CsrMatrix.from_coo(rows, cols, vals, 100, torch.device("cpu"))
    with pytest.raises(ValueError, match="column index out of range"):
        CsrMatrix.from_coo(rows, cols + 300, vals, 300, torch.device("cpu"))
    with pytest.raises(ValueError, match="malformed COO"):
        CsrMatrix.from_coo(rows, cols[:-1], vals, 300, torch.device("cpu"))
    # a matrix with other values keeps the pattern
    d = b.with_vals(b.vals * 2)
    assert d.indices is b.indices and torch.equal(d.vals, b.vals * 2)


def _rows_with_zero(n=300, d=24, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    x[5] = 0.0
    return x


@pytest.mark.parametrize("method", ["l2", "l1"])
def test_normalize_matches_jax(method):
    x = _rows_with_zero()
    ref = np.asarray(jax_normalize(jnp.asarray(x), method))
    t = torch.from_numpy(x.copy())
    out = normalize(t, method)
    assert out.data_ptr() == t.data_ptr()  # in place
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    assert np.all(out.numpy()[5] == 0.0)
    plain = {"l2": l2_normalize_plain, "l1": l1_normalize_plain}[method]
    wrapper = {"l2": l2_normalize, "l1": l1_normalize}[method]
    assert torch.equal(wrapper(torch.from_numpy(x.copy())),
                       plain(torch.from_numpy(x.copy())))


def test_spectral_normalize_gram_and_errors():
    x = _rows_with_zero(n=60, d=12)
    ref = np.asarray(jax_spectral(jnp.asarray(x)))
    ours = spectral_normalize(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_allclose(ours @ ours.T, ref @ ref.T, atol=1e-5)
    t = torch.from_numpy(x)
    assert normalize(t, "none") is t
    with pytest.raises(ValueError) as ours_err:
        normalize(t, "banana")
    with pytest.raises(ValueError) as ref_err:
        jax_normalize(jnp.asarray(x), "banana")
    assert str(ours_err.value) == str(ref_err.value)


def test_whiten_gram_matches_jax():
    # a rotated spectrum from 0.5 to 2 (covariance condition number 16):
    # the whitened Gram is Xc·C⁻¹·Xcᵀ, so an ill-conditioned C would
    # measure float32 rounding, not the port
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((32, 32)))
    x = ((rng.standard_normal((2000, 32)) * np.linspace(0.5, 2.0, 32)) @ q
         ).astype(np.float32) + 0.5
    ref = np.asarray(jax_whiten(jnp.asarray(x)))
    ours = whiten(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours @ ours.T, ref @ ref.T, atol=1e-4)
    assert np.allclose(np.cov(ours, rowvar=False), np.eye(32), atol=1e-3)
    four = whiten(torch.from_numpy(x), n_components=4).numpy()
    ref4 = np.asarray(jax_whiten(jnp.asarray(x), n_components=4))
    np.testing.assert_allclose(four @ four.T, ref4 @ ref4.T, atol=1e-4)
    tiny = torch.ones((1, 4))
    assert whiten(tiny) is tiny
    bf = whiten(torch.from_numpy(x).to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16


def test_memory_estimate_and_fit_check(monkeypatch):
    n, d, nnz = 1000, 256, 5000
    assert memory.estimate_embed_bytes(n, d, nnz) == (
        2 * n * d * 4 + n * d * 4 + 2 * n * d * 4 + nnz * 8 + (n + 1) * 8)
    assert (memory.estimate_embed_bytes(n, d, nnz, "bfloat16")
            < memory.estimate_embed_bytes(n, d, nnz))
    # the CPU has no device limit: never raises
    memory.check_device_fit(10**9, 256, 10**9, device=torch.device("cpu"))
    monkeypatch.setattr(memory, "device_memory_limit", lambda dev: 4 << 20)
    with pytest.raises(ValueError, match='pass dtype="bfloat16"'):
        memory.check_device_fit(n, d, nnz, device=torch.device("cuda"))
    monkeypatch.setenv("CLEORA_TPU_SKIP_FIT_CHECK", "1")
    memory.check_device_fit(n, d, nnz, device=torch.device("cuda"))


def test_kernel_wrappers_refuse_cpu_tensors():
    _, cols, vals, indptr = random_csr(50, seed=9)
    csr = _csr(indptr, cols, vals)
    x = torch.zeros((50, 8))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.spmm_csr(csr.indptr, csr.indices, csr.vals, x)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.row_normalize_(x, "l2")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hash_init(torch.zeros(50, dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.edge_attention(csr.indptr, csr.indices, csr.vals, x, 1.0)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    for name in build.KERNELS:
        assert build.source_path(name).endswith(f"{name}.cu")
