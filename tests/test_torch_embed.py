"""The port's embed() against cleora_tpu.embed on the CPU.

One random graph of about 2,000 nodes at D=32, carried into the port with
``from_jax_state`` so both packages propagate the identical matrix.
Tolerances: unwhitened float32 runs rtol=1e-4, atol=1e-5 (40 iterations
of float32 sums taken in another order); whitened runs compare row Gram
matrices (eigh signs are arbitrary) within atol=1e-3; bf16 storage within
atol=2e-2 (bf16 rounds at other places in the two frameworks).
"""

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu_torch as ctt
from cleora_tpu.ops.loop import embed_loop_convergence as jax_loop_convergence
from cleora_tpu.ops.spmm import pad_coo
from cleora_tpu_torch.convert import from_jax_state
from cleora_tpu_torch.ops.loop import embed_loop_convergence, embed_step

D = 32


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(17)
    src = rng.integers(0, 2000, size=6000)
    dst = rng.integers(0, 2000, size=6000)
    ref = ct.SparseMatrix.from_edge_arrays(src, dst)
    return ref, from_jax_state(ref.__getstate__())


def _both(graphs, **kw):
    ref, ours = graphs
    return ct.embed(ref, **kw), ctt.embed(ours, device="cpu", **kw)


def _gram_close(a, b, atol):
    np.testing.assert_allclose(a @ a.T, b @ b.T, atol=atol)


@pytest.mark.parametrize("propagation", ["left", "symmetric"])
def test_embed_unwhitened_40_iterations(graphs, propagation):
    ref, ours = _both(graphs, feature_dim=D, num_iterations=40,
                      propagation=propagation, whiten=False)
    assert ours.dtype == np.float32 and ours.flags.writeable
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("propagation", ["left", "symmetric"])
def test_embed_whitened_gram(graphs, propagation):
    ref, ours = _both(graphs, feature_dim=D, num_iterations=5,
                      propagation=propagation, whiten=True)
    _gram_close(ours, ref, atol=1e-3)


@pytest.mark.parametrize("propagation", ["left", "symmetric"])
def test_convergence_stops_at_same_iteration(graphs, propagation):
    ref_g, our_g = graphs
    ref, ref_iters = ref_g.embed_fast_convergence(
        D, 40, propagation, convergence_threshold=2e-3)
    ours, our_iters = our_g.embed_fast_convergence(
        D, 40, propagation, convergence_threshold=2e-3, device="cpu")
    assert 1 < our_iters < 40
    assert our_iters == ref_iters
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)
    ref_e, ours_e = _both(graphs, feature_dim=D, num_iterations=40,
                          propagation=propagation, whiten=False,
                          convergence_threshold=2e-3)
    np.testing.assert_allclose(ours_e, ref_e, rtol=1e-4, atol=1e-5)


def test_embed_fast_and_propagate(graphs):
    ref_g, our_g = graphs
    np.testing.assert_allclose(
        our_g.embed_fast(D, 10, "symmetric", seed=2, residual_weight=0.4,
                         device="cpu"),
        ref_g.embed_fast(D, 10, "symmetric", seed=2, residual_weight=0.4),
        rtol=1e-4, atol=1e-5)
    x = np.random.default_rng(0).standard_normal(
        (our_g.num_entities, 8)).astype(np.float32)
    for name in ("left_markov_propagate", "symmetric_markov_propagate"):
        np.testing.assert_allclose(
            getattr(our_g, name)(x, device="cpu"), getattr(ref_g, name)(x),
            rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="rows but graph has"):
        our_g.left_markov_propagate(x[:-1], device="cpu")


def test_callback_path(graphs):
    seen = {"ref": [], "ours": []}

    def recorder(key):
        return lambda i, e: seen[key].append((i, e.copy()))

    ref_g, our_g = graphs
    ref = ct.embed(ref_g, feature_dim=D, num_iterations=40, whiten=False,
                   convergence_threshold=2e-3, callback=recorder("ref"))
    ours = ctt.embed(our_g, feature_dim=D, num_iterations=40, whiten=False,
                     convergence_threshold=2e-3, callback=recorder("ours"),
                     device="cpu")
    assert 1 < len(seen["ours"]) < 40
    assert [i for i, _ in seen["ours"]] == [i for i, _ in seen["ref"]]
    for (_, a), (_, b) in zip(seen["ours"], seen["ref"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_initial_embeddings_l1(graphs):
    ref_g, our_g = graphs
    x0 = np.random.default_rng(3).random(
        (our_g.num_entities, 12)).astype(np.float32)
    ref, ours = _both(graphs, num_iterations=10, normalization="l1",
                      whiten=False, initial_embeddings=x0)
    assert ours.shape == (our_g.num_entities, 12)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("w", [0.3, 1.5])
def test_residual_both_behaviours(graphs, w):
    # Rust fast-path semantics (l2, no whiten/callback/init): w >= 1 is
    # ignored; the Python slow path (here: l1) applies any w > 0
    for normalization in ("l2", "l1"):
        ref, ours = _both(graphs, feature_dim=D, num_iterations=10,
                          normalization=normalization, whiten=False,
                          residual_weight=w)
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)
    fast_ignored = ctt.embed(graphs[1], feature_dim=D, num_iterations=10,
                             whiten=False, residual_weight=w, device="cpu")
    plain = ctt.embed(graphs[1], feature_dim=D, num_iterations=10,
                      whiten=False, device="cpu")
    assert np.array_equal(fast_ignored, plain) == (w >= 1.0)


def test_spectral_normalization_gram(graphs):
    ref, ours = _both(graphs, feature_dim=D, num_iterations=3,
                      normalization="spectral", whiten=False)
    _gram_close(ours, ref, atol=1e-4)


def test_bfloat16_storage(graphs):
    ref, ours = _both(graphs, feature_dim=D, num_iterations=5, whiten=False,
                      dtype="bfloat16")
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-2)


@pytest.mark.parametrize("propagation", ["left", "symmetric"])
def test_bfloat16_convergence_stops_at_same_iteration(graphs, propagation):
    """Under bf16 storage the JAX loop takes the RMSE in bf16
    (cleora_tpu/ops/loop.py:125-126); thresholds within 0.2 % of an
    iteration's RMSE tell a float32 RMSE from it."""
    import jax.numpy as jnp

    ref_g, our_g = graphs
    rows, cols, vals, n, _ = ref_g.to_sparse_csr(propagation)
    flat = [jnp.asarray(a) for a in pad_coo(
        rows.astype(np.int32), cols.astype(np.int32), vals, n)]
    x0 = ref_g.initialize_deterministically(D, 0)
    csr = our_g._device_csr(propagation, torch.device("cpu"))
    x = torch.from_numpy(x0).to(torch.bfloat16)
    thresholds = [1e-3, 2e-3, 5e-3, 1e-2]
    for i in range(12):
        y = embed_step(csr, x, 0.0, "l2", False)
        d = y.double() - x.double()
        if i >= 2:
            r = float(torch.sqrt(torch.mean(d * d)))
            thresholds += [0.998 * r, 1.002 * r]
        x = y
    stops = []
    for threshold in thresholds:
        ref, ref_iters = jax_loop_convergence(
            *flat, jnp.asarray(x0).astype(jnp.bfloat16), n_rows=n,
            max_iterations=40, convergence_threshold=threshold)
        ours, our_iters = embed_loop_convergence(
            csr, torch.from_numpy(x0).to(torch.bfloat16), 40, 0.0, threshold)
        assert our_iters == int(ref_iters), threshold
        stops.append(our_iters)
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=0, atol=2e-2)
    assert len(set(stops)) > 5 and min(stops) < 40
    ref, ours = _both(graphs, feature_dim=D, num_iterations=40,
                      propagation=propagation, whiten=False, dtype="bfloat16",
                      convergence_threshold=2e-3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-2)


def test_auto_iterations_and_canonical_shapes_ignored(graphs):
    g = graphs[1]
    a = ctt.embed(g, feature_dim=8, num_iterations="auto", whiten=False,
                  canonical_shapes=True, device="cpu")
    b = ctt.embed(g, feature_dim=8, num_iterations=ctt.DEFAULT_NUM_ITERATIONS,
                  whiten=False, device="cpu")
    assert np.array_equal(a, b)
    assert ctt.DEFAULT_FEATURE_DIM == ct.DEFAULT_FEATURE_DIM


@pytest.mark.parametrize("kwargs", [
    {"dtype": "float16"},
    {"num_iterations": "banana"},
    {"propagation": "banana"},
    {"normalization": "banana"},
    {"initial_embeddings": np.zeros((3, 4), np.float32)},
])
def test_error_strings_match(graphs, kwargs):
    ref_g, our_g = graphs
    with pytest.raises(ValueError) as ref_err:
        ct.embed(ref_g, **kwargs)
    with pytest.raises(ValueError) as our_err:
        ctt.embed(our_g, device="cpu", **kwargs)
    assert str(our_err.value) == str(ref_err.value)


def test_disk_graph_not_ported(tmp_path):
    """embed() takes a streamed build (through the sharded loop, held
    against the JAX package in tests/test_torch_sharded.py), and so do the
    walk siblings (queue A item 7, ported: the walk CSR read off the
    memmaps, so the result is bitwise the in-RAM graph's); anything else
    is refused."""
    from cleora_tpu_torch.algorithms import embed_deepwalk
    from cleora_tpu_torch.graph.stream import build_graph_streaming

    lines = ["a b", "b c", "c d", "d a"]
    dg = build_graph_streaming(lines, "complex::reflexive::node",
                               str(tmp_path / "g"))
    sm = ctt.SparseMatrix.from_iterator(iter(lines),
                                        "complex::reflexive::node")
    np.testing.assert_array_equal(
        ctt.embed(dg, feature_dim=8, num_iterations=3, device="cpu"),
        ctt.embed(sm, feature_dim=8, num_iterations=3, device="cpu"))
    from cleora_tpu_torch.algorithms import _walk_csr

    for a, b in zip(_walk_csr(dg, with_vals=True),
                    _walk_csr(sm, with_vals=True)):
        np.testing.assert_array_equal(a, b)
    kw = dict(feature_dim=4, num_walks=2, walk_length=6, backend="device",
              cooccurrence="device", device="cpu")
    np.testing.assert_array_equal(embed_deepwalk(dg, **kw),
                                  embed_deepwalk(sm, **kw))
    with pytest.raises(TypeError, match="SparseMatrix or a DiskGraph"):
        ctt.embed(object(), device="cpu")


def test_device_rule(graphs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ctt.embed(graphs[1], feature_dim=8, num_iterations=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graphs[1].left_markov_propagate(
            np.zeros((graphs[1].num_entities, 4), np.float32))
