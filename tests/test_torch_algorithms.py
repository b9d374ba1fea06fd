"""The port's spectral siblings against the JAX package's, on the CPU.

One seeded ~300-node graph is built by the JAX package and carried into the
port with ``from_jax_state``, so both packages factorise the same matrix.
Both draw ``R`` and ``omega`` from ``np.random.default_rng(seed)``, so the
sketches are equal.  The port runs ``backend="device", device="cpu"`` (the
kernels' plain versions); the JAX package runs ``backend="device"`` on its
CPU platform.

Tolerances:

- plain versions of K5/K6/K7 against a float32 numpy restatement of the JAX
  lines they port: atol=1e-6 (the same float32 operations; only the row
  sums may be taken in another order), plus rtol=2e-7 for the log-clip,
  where two logf libraries may differ in the last bit of a value near 23;
- the Chebyshev and weighted-sum cores: rtol=1e-4, atol=1e-5.  JAX rounds
  ``2.0·(curr − N·curr) − prev`` in that order and the port
  ``−2·N·curr + 2·curr − prev``, an ulp or two per step, and the JAX SpMM
  sums each row in its ELL order; eight steps stay far inside this;
- entry points, device backends: RandNE allclose atol=1e-4; ProNE, HOPE and
  GraRep up to per-column signs (SVD sign ambiguity) atol=1e-3, with a
  sketch of width ≥ n so the randomized SVD spans the full range; NetMF by
  its Gram matrix atol=5e-3, because its log matrix has a degenerate
  singular subspace that two SVDs rotate freely;
- entry points, host backends: the same float64 numpy/scipy code, so RandNE
  is exactly equal and the others agree up to signs at atol=1e-6;
- blocked against dense inside the port: the same sketch in another
  summation order, signs aligned atol=1e-3 and Gram atol=5e-3.
"""

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu.algorithms as jalg
import cleora_tpu_torch.algorithms as talg
from cleora_tpu_torch import kernels
from cleora_tpu_torch.convert import from_jax_state
from cleora_tpu_torch.kernels import build
from cleora_tpu_torch.ops import memory
from cleora_tpu_torch.ops.dense import (
    dense_markov,
    dense_markov_plain,
    log_clip,
    log_clip_plain,
    rsvd_u_sqrt,
)
from cleora_tpu_torch.ops.spmm import (
    CsrMatrix,
    spmm_axpy,
    spmm_axpy_plain,
    spmm_plain,
)

CPU = torch.device("cpu")
ENTRY_POINTS = ("prone", "randne", "hope", "netmf", "grarep")


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


def _random_coo(n, seed, duplicates=False):
    """Row-sorted COO with an empty row 3 and, optionally, repeated
    (row, col) entries."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, size=n)
    deg[3 % n] = 0
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.shape[0])
    if duplicates and rows.size > 4:
        cols[1] = cols[0] if rows[1] == rows[0] else cols[1]
        rows = np.concatenate([rows, rows[-2:]])
        cols = np.concatenate([cols, cols[-2:]])
    vals = rng.random(rows.shape[0]).astype(np.float32)
    return rows, cols, vals


# ------------------------------------------------------------- plain versions
@pytest.mark.parametrize("case", ["randne", "chebyshev", "katz"])
def test_spmm_axpy_plain_matches_numpy_restatement(case):
    n, d = 200, 12
    rows, cols, vals = _random_coo(n, seed=1)
    vals = (vals / 4).astype(np.float32)
    rng = np.random.default_rng(2)
    x, z, acc = (rng.standard_normal((n, d)).astype(np.float32)
                 for _ in range(3))
    nx = np.zeros((n, d), np.float32)
    np.add.at(nx, rows, vals[:, None] * x[cols])
    csr = CsrMatrix.from_coo(rows, cols, vals, n, CPU)
    tx, tz, tacc = (torch.from_numpy(a.copy()) for a in (x, z, acc))
    if case == "randne":  # algorithms.py:127-128
        w = np.float32(0.25)
        out = spmm_axpy_plain(csr, tx, 1.0, acc=tacc, d=float(w))
        want_out, want_acc = nx, acc + w * nx
    elif case == "chebyshev":  # algorithms.py:202, :210-212
        coeff = np.float32(0.07)
        out = spmm_axpy_plain(csr, tx, -2.0, 2.0, z=tz, c=-1.0, acc=tacc,
                              d=float(coeff))
        want_out = np.float32(2.0) * (x - nx) - z
        want_acc = acc + coeff * want_out
    else:  # algorithms.py:288-289
        beta = np.float32(0.1)
        out = spmm_axpy_plain(csr, tx, float(beta), acc=tacc, d=1.0)
        want_out = beta * nx
        want_acc = acc + want_out
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tacc.numpy(), want_acc, rtol=0, atol=1e-6)
    # the inputs are left alone, and without acc nothing is updated
    assert np.array_equal(tx.numpy(), x) and np.array_equal(tz.numpy(), z)
    lone = spmm_axpy_plain(csr, tx, -1.0, 1.0)  # L·x, algorithms.py:202
    np.testing.assert_allclose(lone.numpy(), x - nx, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 57, 200])
def test_dense_markov_plain_matches_numpy_restatement(n):
    rows, cols, vals = _random_coo(n, seed=n, duplicates=True)
    a = np.zeros((n, n), np.float32)  # algorithms.py:402-404
    np.add.at(a, (rows, cols), vals)
    deg = np.maximum(a.sum(axis=1), np.float32(1e-10))
    order = np.argsort(rows, kind="stable")
    csr = CsrMatrix.from_coo(rows[order], cols[order], vals[order], n, CPU)
    p, got_deg, vol = dense_markov_plain(csr)
    assert p.dtype == torch.float32 and vol.dtype == torch.float64
    assert vol.shape == (1,)
    np.testing.assert_allclose(p.numpy(), a / deg[:, None], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_deg.numpy(), deg, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vol.item(), a.astype(np.float64).sum(),
                               rtol=1e-6)
    if n > 3:
        assert got_deg[3] == np.float32(1e-10) and not p[3].any()


@pytest.mark.parametrize("mode", ["netmf", "grarep"])
@pytest.mark.parametrize("scaled", [True, False])
def test_log_clip_plain_matches_numpy_restatement(mode, scaled):
    rng = np.random.default_rng(3)
    x = (rng.random((40, 28)) * 4).astype(np.float32)
    x[x < 0.5] = 0.0
    r = (rng.random(40) + 0.5).astype(np.float32) if scaled else None
    c = (rng.random(28) + 0.5).astype(np.float32) if scaled else None
    m = x if not scaled else x * r[:, None] * c[None, :]
    if mode == "netmf":  # algorithms.py:429-430
        floor, offset = 1.0, 0.0
        want = np.log(np.maximum(m, np.float32(1.0)))
    else:  # algorithms.py:459-461
        floor, offset = talg._GRAREP_FLOOR, talg._GRAREP_OFFSET
        want = (np.log(np.maximum(m, np.float32(1e-10)))
                - np.log(np.float32(1e-10)))
    t = torch.from_numpy(x.copy())
    got = log_clip_plain(
        t, None if r is None else torch.from_numpy(r),
        None if c is None else torch.from_numpy(c), floor, offset)
    assert got.data_ptr() == t.data_ptr()  # in place, like the kernel
    # rtol: numpy's and torch's logf may round the last bit differently,
    # and one float32 ulp at GraRep's values (~23) is 1.9e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=1e-6)


def test_wrappers_run_plain_versions_on_cpu_and_launch_nothing():
    n = 60
    rows, cols, vals = _random_coo(n, seed=5)
    csr = CsrMatrix.from_coo(rows, cols, vals, n, CPU)
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((n, 8)).astype(np.float32))
    kernels.reset_launches()
    a1, a2 = torch.zeros_like(x), torch.zeros_like(x)
    assert torch.equal(spmm_axpy(csr, x, 0.5, 2.0, z=x, c=-1.0, acc=a1, d=3.0),
                       spmm_axpy_plain(csr, x, 0.5, 2.0, z=x, c=-1.0, acc=a2,
                                       d=3.0))
    assert torch.equal(a1, a2) and a1.abs().sum() > 0
    for got, want in zip(dense_markov(csr), dense_markov_plain(csr)):
        assert torch.equal(got, want)
    assert torch.equal(log_clip(x.abs(), None, None, 1.0, 0.0),
                       log_clip_plain(x.abs(), None, None, 1.0, 0.0))
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_transpose_from_coo_is_the_transpose_in_stable_order():
    n = 80
    rows, cols, vals = _random_coo(n, seed=6, duplicates=True)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    a = CsrMatrix.from_coo(rows, cols, vals, n, CPU)
    t = CsrMatrix.transpose_from_coo(rows, cols, vals, n, CPU)
    x = torch.eye(n)
    assert torch.equal(spmm_plain(t, x), spmm_plain(a, x).T.contiguous())
    # each row of Aᵀ lists A's rows in ascending order (stable argsort)
    for j in range(n):
        seg = t.indices[int(t.indptr[j]):int(t.indptr[j + 1])].numpy()
        assert np.all(np.diff(seg) >= 0)
    with pytest.raises(ValueError, match="malformed COO"):
        CsrMatrix.transpose_from_coo(rows, cols[:-1], vals, n, CPU)


# ---------------------------------------------------------- cores against JAX
def test_prone_chebyshev_core_matches_jax(graphs):
    ref, g = graphs
    dev, rank = jalg._prone_chebyshev_core(ref, 16, 0.2, 0.5, 0)
    want = np.asarray(dev)
    want = want[np.asarray(rank)] if rank is not None else want
    got = talg._prone_chebyshev_core(g, 16, 0.2, 0.5, 0, "cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sym_norm", [True, False])
def test_device_spmm_weighted_sum_matches_jax(graphs, sym_norm):
    ref, g = graphs
    R = np.random.default_rng(4).standard_normal((g.num_entities, 16))
    w = [1.0 / 2**i for i in range(11)]
    want = jalg._device_spmm_weighted_sum(ref, R, w, sym_norm)
    got = talg._device_spmm_weighted_sum(g, R, w, sym_norm, "cpu")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_katz_series_takes_a_column_major_operand():
    """A CUDA QR hands back a column-major Q; the series' accumulator, which
    kernel K5 updates in place, must be row-major all the same."""
    n = 50
    rows, cols, vals = _random_coo(n, seed=7)
    csr = CsrMatrix.from_coo(rows, cols, (vals / 8).astype(np.float32), n, CPU)
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((6, n)).astype(np.float32)).T
    assert not x.is_contiguous()
    got = talg._katz(csr, x, 0.5, 3)
    assert got.is_contiguous()
    a = torch.zeros((n, n)).index_put_(
        (torch.from_numpy(rows), torch.from_numpy(cols)),
        csr.vals, accumulate=True).double()
    want = sum(0.5**k * torch.linalg.matrix_power(a, k) for k in (1, 2, 3)
               ) @ x.double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


# --------------------------------------------------- entry points against JAX
def _kwargs(name, n):
    """Per-algorithm arguments; the sketched ones get a sketch of width
    ≥ n, so the randomized SVD is exact up to float32 rounding."""
    return {
        "prone": dict(feature_dim=16),
        "randne": dict(feature_dim=16, num_iterations=10),
        "hope": dict(feature_dim=16, oversample=n, power_iters=2),
        "netmf": dict(feature_dim=16, oversample=n, power_iters=2),
        "grarep": dict(feature_dim=16, max_step=4, oversample=n,
                       power_iters=2),
    }[name]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_device_backend_matches_jax_device_backend(graphs, name):
    ref, g = graphs
    kw = _kwargs(name, g.num_entities)
    want = getattr(jalg, f"embed_{name}")(ref, backend="device", **kw)
    kernels.reset_launches()
    got = getattr(talg, f"embed_{name}")(g, backend="device", device="cpu",
                                         **kw)
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)
    assert got.shape == want.shape == (g.num_entities, 16)
    assert got.dtype == np.float32 and got.flags.writeable
    if name == "randne":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    elif name == "netmf":
        np.testing.assert_allclose(got @ got.T, want @ want.T, rtol=0,
                                   atol=5e-3)
    else:
        assert _aligned_err(got, want) <= 1e-3


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_host_backend_matches_jax_host_backend(graphs, name):
    ref, g = graphs
    kw = dict(feature_dim=16)
    if name == "randne":
        kw["num_iterations"] = 10
    want = getattr(jalg, f"embed_{name}")(ref, **kw)
    # backend="host" ignores device: no card is needed or looked for
    got = getattr(talg, f"embed_{name}")(g, **kw)
    assert got.dtype == np.float32
    if name == "randne":
        assert np.array_equal(got, want)
    else:
        assert _aligned_err(got, want) <= 1e-6


def test_randne_custom_weights_and_converted_graph_state(graphs):
    ref, g = graphs
    w = [1.0, 0.5, 0.1]  # shorter than the loop: the last weight repeats
    want = jalg.embed_randne(ref, feature_dim=8, num_iterations=5, weights=w,
                             backend="device")
    got = talg.embed_randne(g, feature_dim=8, num_iterations=5, weights=w,
                            backend="device", device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ------------------------------------------------- blocked against dense
@pytest.mark.parametrize("name", ["netmf", "grarep"])
@pytest.mark.parametrize("full_sketch", [True, False])
def test_blocked_matches_dense(graphs, name, full_sketch):
    _, g = graphs
    n = g.num_entities
    kw = dict(feature_dim=16, backend="device", device="cpu")
    if full_sketch:
        kw.update(oversample=n, power_iters=2)
    fn = getattr(talg, f"embed_{name}")
    dense = fn(g, **kw)
    assert n % 70 != 0  # the last block is ragged
    blocked = fn(g, block_rows=70, **kw)
    assert _aligned_err(blocked, dense) <= 1e-3
    np.testing.assert_allclose(blocked @ blocked.T, dense @ dense.T, rtol=0,
                               atol=5e-3)
    # one block wider than the graph is clamped to n
    wide = fn(g, block_rows=4 * n, **kw)
    assert _aligned_err(wide, dense) <= 1e-3


def test_auto_block_rows_formula():
    # no budget known (the CPU): the widest block, clamped to n
    assert talg._auto_block_rows(10_000, 266) == 4096
    assert talg._auto_block_rows(300, 26) == 256
    assert talg._auto_block_rows(100, 26) == 100
    # half the budget less six (n, r) operands, over 16 n bytes a column
    n, r, limit = 200_000, 266, 8 << 30
    b = (int(limit * 0.5) - 6 * n * r * 4) // (16 * n)
    assert talg._auto_block_rows(n, r, limit=limit) == (b // 128) * 128
    assert talg._auto_block_rows(n, r, limit=limit) == jalg._auto_block_rows(
        n, r, limit=limit)
    assert talg._auto_block_rows(n, r, limit=1 << 30) == 8


# --------------------------------------------------------------- the contract
def test_hope_beta_check_error_string(graphs):
    ref, g = graphs
    with pytest.raises(ValueError) as want:
        jalg.embed_hope(ref, feature_dim=16, backend="device", beta=1.5)
    with pytest.raises(ValueError) as got:
        talg.embed_hope(g, feature_dim=16, backend="device", beta=1.5,
                        device="cpu")
    assert str(got.value) == str(want.value)
    assert "beta * ||A||_inf < 1" in str(got.value)


def test_dense_gate_error_string_and_bypass(graphs, monkeypatch):
    from cleora_tpu.ops import memory as jax_memory

    monkeypatch.setattr(jax_memory, "device_hbm_limit", lambda: 16 << 30)
    monkeypatch.setattr(
        memory, "device_memory_limit",
        lambda dev: 16 << 30 if dev.type == "cuda" else None)
    card = torch.device("cuda")
    with pytest.raises(ValueError) as want:
        jalg._check_dense_fit(100_000)
    with pytest.raises(ValueError) as got:
        talg._check_dense_fit(100_000, device=card)
    assert str(got.value) == str(want.value)
    assert "backend='host'" in str(got.value) and "HBM" in str(got.value)
    assert not talg._dense_fits(100_000, device=card)
    assert talg._dense_fits(1_000, device=card)
    assert talg._dense_fits(100_000, device=CPU)  # the CPU has no budget
    assert talg._dense_fits(100_000, limit=1 << 40)
    monkeypatch.setenv("CLEORA_TPU_SKIP_FIT_CHECK", "1")
    talg._check_dense_fit(100_000, device=card)  # bypass honoured
    assert talg._dense_fits(100_000, device=card)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_sharded_arguments_raise_not_implemented(graphs, name):
    """The sharded backends run (tests/test_torch_sharded_algorithms.py);
    what they refuse: two shards without a process group (make_mesh's
    message names torchrun) and a mesh that is not a ShardGroup."""
    _, g = graphs
    fn = getattr(talg, f"embed_{name}")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        fn(g, feature_dim=8, backend="device", device="cpu", n_devices=2)
    with pytest.raises(TypeError, match="ShardGroup"):
        fn(g, feature_dim=8, backend="device", device="cpu", mesh=object())


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_device_backend_without_a_card_raises(graphs, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    _, g = graphs
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        getattr(talg, f"embed_{name}")(g, feature_dim=8, backend="device")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_out_returns_read_only_memmap(graphs, name, tmp_path):
    _, g = graphs
    kw = dict(feature_dim=8, backend="device", device="cpu")
    fn = getattr(talg, f"embed_{name}")
    mem = fn(g, **kw)
    path = str(tmp_path / f"{name}.npy")
    mm = fn(g, out=path, **kw)
    assert isinstance(mm, np.memmap) and not mm.flags.writeable
    assert mm.dtype == np.float32 and np.array_equal(np.asarray(mm), mem)
    assert np.array_equal(np.load(path), mem)
    norms = np.linalg.norm(mem, axis=1)
    assert np.all((norms < 1.001) & (norms > 0.99) | (norms < 1e-6))


def test_signatures_are_the_jax_ones_plus_device():
    import inspect

    for name in ENTRY_POINTS:
        want = inspect.signature(getattr(jalg, f"embed_{name}")).parameters
        got = inspect.signature(getattr(talg, f"embed_{name}")).parameters
        assert list(got) == [*want, "device"]
        for key, p in want.items():
            assert got[key].default == p.default, (name, key)
        assert got["device"].default is None


# ------------------------------------------------------- float32 matmul guard
def test_products_run_in_full_float32_whatever_the_caller_set(monkeypatch):
    from cleora_tpu_torch.ops.whiten import whiten

    flag = torch.backends.cuda.matmul
    monkeypatch.setattr(flag, "allow_tf32", True)
    seen = []
    real = torch.matmul

    def spy(*args, **kwargs):
        seen.append(flag.allow_tf32)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "matmul", spy)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((50, 6)).astype(np.float32))
    whiten(x)
    assert seen == [False, False] and flag.allow_tf32 is True
    del seen[:]
    m = torch.from_numpy(rng.standard_normal((30, 30)).astype(np.float32))
    om = torch.from_numpy(rng.standard_normal((30, 30)).astype(np.float32))
    u = rsvd_u_sqrt(m, om, 5, 1)
    assert len(seen) == 5 and not any(seen) and flag.allow_tf32 is True
    # exact at full sketch width: U_k·√S_k of m up to signs
    uu, ss, _ = np.linalg.svd(m.numpy().astype(np.float64))
    assert _aligned_err(u.numpy(), uu[:, :5] * np.sqrt(ss[:5])) <= 1e-4
    # an exception inside the block still restores the caller's setting
    with pytest.raises(RuntimeError):
        rsvd_u_sqrt(m, om[:7], 5, 1)
    assert flag.allow_tf32 is True


def test_float32_guard_puts_back_the_callers_precision_word_for_word():
    """"medium" comes back as "medium", not as the "high" that restoring
    allow_tf32 = True alone would leave."""
    from cleora_tpu_torch._util import full_float32_matmul

    try:
        for mine in ("medium", "high", "highest"):
            torch.set_float32_matmul_precision(mine)
            with full_float32_matmul():
                assert torch.get_float32_matmul_precision() == "highest"
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == mine
    finally:
        torch.set_float32_matmul_precision("highest")  # torch's default
