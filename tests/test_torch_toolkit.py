"""The port's retrieval toolkit (search, compress, community) against the
JAX package's, on the CPU.

Graphs are built by the JAX package and carried into the port with
``from_jax_state``; embeddings are seeded numpy clusters.  The port runs
``device="cpu"`` (the same PyTorch calls the card runs, with K13's plain
version); the JAX package runs on its CPU platform (``ShardedDeviceIndex``
there shards over the virtual 8-device mesh).

Tolerances: host paths (ball tree, brute force, ``backend="host"``,
product quantization, PCA, projections, Louvain, modularity): the same
numpy code, exactly equal; device paths: the same indices (PQ scores
tie where codes repeat: there an index may move within its tie), scores
atol=1e-5 (float32 products and einsums summed in another order);
``pq_adc_plain`` bitwise against the host loop on the same tables;
k-means labels exactly equal above and below the 2¹⁸ device gate.
"""

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu.community as jcom
import cleora_tpu.compress as jcp
import cleora_tpu.search as jsearch
import cleora_tpu_torch.community as tcom
import cleora_tpu_torch.compress as tcp
import cleora_tpu_torch.search as tsearch
from cleora_tpu_torch import kernels
from cleora_tpu_torch.convert import from_jax_state
from cleora_tpu_torch.kernels import build
from cleora_tpu_torch.ops.pq import device_codes, pq_adc, pq_adc_plain


def _clustered(n, d, k, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    centers = rng.normal(size=(k, d))
    return (centers[labels] + 0.35 * rng.normal(size=(n, d))).astype(
        np.float32)


def _graphs(n, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 4 * n)
    src[:n] = np.arange(n)
    ref = ct.SparseMatrix.from_edge_arrays(src, rng.integers(0, n, 4 * n))
    assert ref.num_entities == n
    return ref, from_jax_state(ref.__getstate__())


@pytest.fixture(scope="module")
def setup():
    ref, g = _graphs(600, 1)
    return ref, g, _clustered(600, 32, 6, 2)


def _same_results(got, want, atol=1e-5):
    assert [r["index"] for r in got] == [r["index"] for r in want]
    assert [r["entity_id"] for r in got] == [r["entity_id"] for r in want]
    np.testing.assert_allclose([r["similarity"] for r in got],
                               [r["similarity"] for r in want], rtol=0,
                               atol=atol)


# -------------------------------------------------------------------- search
@pytest.mark.parametrize("method", ["hnsw", "brute", "device"])
def test_ann_index_matches_jax(setup, method):
    ref, g, emb = setup
    ours = tsearch.ANNIndex(g, emb, method=method, device="cpu")
    theirs = jsearch.ANNIndex(ref, emb, method=method)
    atol = 1e-5 if method == "device" else 0.0
    for eid in ("0", "77", "599"):
        for exclude in (True, False):
            _same_results(ours.query(eid, top_k=5, exclude_self=exclude),
                          theirs.query(eid, top_k=5, exclude_self=exclude),
                          atol)
    _same_results(ours.query_vector(emb[3] * 2.0, top_k=7),
                  theirs.query_vector(emb[3] * 2.0, top_k=7), atol)
    queries = emb[[7, 0, 12, 400]]
    for got, want in zip(ours.query_batch(queries, top_k=4),
                         theirs.query_batch(queries, top_k=4)):
        _same_results(got, want, atol)
    # k past the table: every row, in order
    assert len(ours.query_batch(queries[:1], top_k=10_000)[0]) == 600


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_device_index_on_one_device_matches_jax(setup, dtype):
    ref, g, emb = setup
    ours = tsearch.ShardedDeviceIndex(g, emb, dtype=dtype, device="cpu")
    theirs = jsearch.ShardedDeviceIndex(ref, emb, dtype=dtype)
    for eid in ("0", "33", "598"):
        _same_results(ours.query(eid, top_k=5), theirs.query(eid, top_k=5))
    _same_results(ours.query_vector(emb[9], top_k=6),
                  theirs.query_vector(emb[9], top_k=6))
    queries = emb[[7, 0, 12, 401]]
    for got, want in zip(ours.query_batch(queries, top_k=4),
                         theirs.query_batch(queries, top_k=4)):
        _same_results(got, want)
    if dtype == "float32":
        brute = tsearch.ANNIndex(g, emb, method="brute")
        for got, want in zip(ours.query_batch(queries, top_k=4),
                             brute.query_batch(queries, top_k=4)):
            _same_results(got, want)


def test_search_errors_are_the_jax_ones(setup):
    ref, g, emb = setup
    cases = [
        (lambda m: m.ANNIndex(ref if m is jsearch else g, emb,
                              method="bogus"), ValueError),
        (lambda m: m.ANNIndex(ref if m is jsearch else g, emb,
                              method="brute").query("0", top_k=0),
         ValueError),
        (lambda m: m.ANNIndex(ref if m is jsearch else g, emb,
                              method="brute").query_batch(emb[:2, :-1]),
         ValueError),
        (lambda m: m.ShardedDeviceIndex(ref if m is jsearch else g, emb,
                                        dtype="float16"), ValueError),
    ]
    for call, exc in cases:
        with pytest.raises(exc) as want:
            call(jsearch)
        with pytest.raises(exc) as got:
            call(tsearch)
        assert str(got.value) == str(want.value)
    ours = tsearch.ShardedDeviceIndex(g, emb, device="cpu")
    theirs = jsearch.ShardedDeviceIndex(ref, emb)
    for call in (lambda i: i.query_batch(emb[:2, :-1]),
                 lambda i: i.query_batch(emb[:2], top_k=0),
                 lambda i: i.query("0", top_k=-1)):
        with pytest.raises(ValueError) as want:
            call(theirs)
        with pytest.raises(ValueError) as got:
            call(ours)
        assert str(got.value) == str(want.value)
    # mesh= (queue A item 8, ported) takes a parallel.ShardGroup; one
    # shard of this process holds the whole table
    with pytest.raises(TypeError, match="ShardGroup"):
        tsearch.ShardedDeviceIndex(g, emb, mesh=object(), device="cpu")
    from cleora_tpu_torch.parallel import make_mesh

    one = tsearch.ShardedDeviceIndex(g, emb, mesh=make_mesh(device="cpu"))
    _same_results(one.query("33", top_k=5), ours.query("33", top_k=5))


def test_device_search_without_a_card_raises(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    _, g, emb = setup
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        tsearch.ANNIndex(g, emb, method="device")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        tsearch.ShardedDeviceIndex(g, emb)
    pq = tcp.product_quantize(emb, num_subspaces=4, num_centroids=8, seed=0)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        pq.search_batch(emb[:2])
    tsearch.ANNIndex(g, emb, method="brute")  # host methods need no card


# ------------------------------------------------------------------ compress
def test_pca_and_random_projection_equal_jax(setup):
    _, _, emb = setup
    assert np.array_equal(tcp.pca_compress(emb, 4), jcp.pca_compress(emb, 4))
    assert np.array_equal(tcp.random_projection(emb, 8, seed=3),
                          jcp.random_projection(emb, 8, seed=3))
    for target in (0, 33):
        with pytest.raises(ValueError) as want:
            jcp.pca_compress(emb, target)
        with pytest.raises(ValueError) as got:
            tcp.pca_compress(emb, target)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("centroids", [16, 300])
def test_product_quantize_is_bitwise_the_jax_one(setup, centroids):
    _, _, emb = setup
    ours = tcp.product_quantize(emb, num_subspaces=4, num_centroids=centroids,
                                max_iter=5, seed=7, device="cpu")
    theirs = jcp.product_quantize(emb, num_subspaces=4,
                                  num_centroids=centroids, max_iter=5, seed=7)
    assert ours._codes.dtype == theirs._codes.dtype == (
        np.uint8 if centroids <= 256 else np.uint16)
    assert np.array_equal(ours._codes, theirs._codes)
    assert np.array_equal(ours._codebooks, theirs._codebooks)
    assert np.array_equal(ours.reconstruct(), theirs.reconstruct())
    for qi in (5, 0):
        got, want = ours.search(emb[qi], top_k=5), theirs.search(emb[qi],
                                                                 top_k=5)
        assert np.array_equal(got["indices"], want["indices"])
        assert np.array_equal(got["scores"], want["scores"])
    queries = emb[[5, 0, 11, 321]]
    got = ours.search_batch(queries, top_k=5, backend="host")
    want = theirs.search_batch(queries, top_k=5, backend="host")
    assert np.array_equal(got["indices"], want["indices"])
    assert np.array_equal(got["scores"], want["scores"])
    full = ours.search_batch(queries, top_k=emb.shape[0], backend="host")
    every = np.empty(full["scores"].shape, np.float32)
    np.put_along_axis(every, full["indices"], full["scores"], axis=1)
    got = ours.search_batch(queries, top_k=5, backend="device")
    want = theirs.search_batch(queries, top_k=5, backend="device")
    assert got["indices"].shape == got["scores"].shape == (4, 5)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    # codes repeat, so scores tie: indices may permute within a tie, and
    # each must carry its score; where a score is unique, the same index
    picked = np.take_along_axis(every, got["indices"].astype(np.int64), 1)
    np.testing.assert_allclose(picked, got["scores"], rtol=0, atol=1e-5)
    for row, idx, want_idx in zip(every, got["indices"], want["indices"]):
        for i, j in zip(idx, want_idx):
            if np.sum(np.abs(row - row[j]) <= 1e-5) == 1:
                assert i == j


def test_pq_adc_plain_matches_the_jax_scores_and_the_host_loop(setup):
    _, _, emb = setup
    ours = tcp.product_quantize(emb, num_subspaces=8, num_centroids=32,
                                max_iter=5, seed=1, device="cpu")
    theirs = jcp.product_quantize(emb, num_subspaces=8, num_centroids=32,
                                  max_iter=5, seed=1)
    queries = emb[[2, 3, 500]]
    n = emb.shape[0]
    # every score of the JAX program's _adc: its top-k over all N rows
    full = theirs.search_batch(queries, top_k=n, backend="device")
    want = np.empty((3, n), np.float32)
    np.put_along_axis(want, full["indices"], full["scores"], axis=1)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    tables = np.einsum("qmd,mcd->qmc", qn.reshape(3, 8, 4),
                       ours._normalized_codebooks()).astype(np.float32)
    got = pq_adc_plain(torch.from_numpy(tables),
                       torch.from_numpy(ours._codes)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    host = np.zeros((3, n), np.float32)
    for m in range(8):
        host += tables[:, m, ours._codes[:, m]]
    assert np.array_equal(got, host)
    # uint16 and int32 codes give the same sums
    for dtype in (torch.uint16, torch.int32):
        codes = torch.from_numpy(ours._codes.astype(np.int32)).to(dtype)
        assert np.array_equal(pq_adc(torch.from_numpy(tables), codes).numpy(),
                              got)


def test_pq_errors_are_the_jax_ones(setup):
    _, _, emb = setup
    ours = tcp.product_quantize(emb, num_subspaces=4, num_centroids=8,
                                max_iter=2, seed=0, device="cpu")
    theirs = jcp.product_quantize(emb, num_subspaces=4, num_centroids=8,
                                  max_iter=2, seed=0)
    for call in (lambda i: i.search_batch(emb[:2], backend="gpu"),
                 lambda i: i.search_batch(emb[:2, :-1]),
                 lambda i: i.search_batch(emb[0]),
                 lambda i: i.search_batch(emb[:2], top_k=0),
                 lambda i: i.search(emb[0], top_k=0)):
        with pytest.raises(ValueError) as want:
            call(theirs)
        with pytest.raises(ValueError) as got:
            call(ours)
        assert str(got.value) == str(want.value)
    for kw in (dict(num_subspaces=5), dict(num_subspaces=0),
               dict(num_centroids=0), dict(max_iter=0)):
        with pytest.raises(ValueError) as want:
            jcp.product_quantize(emb, **kw)
        with pytest.raises(ValueError) as got:
            tcp.product_quantize(emb, **kw)
        assert str(got.value) == str(want.value)


def test_pq_codes_are_range_checked_once_when_uploaded(setup):
    _, _, emb = setup
    ours = tcp.product_quantize(emb, num_subspaces=4, num_centroids=8,
                                max_iter=2, seed=0, device="cpu")
    ours.search_batch(emb[:2], top_k=3, backend="device")
    state = ours._adc_state
    assert state[1].dtype == torch.uint8
    ours.search_batch(emb[2:4], top_k=3, backend="device")
    assert ours._adc_state is state
    wide = device_codes(ours._codes.astype(np.int64), 8, "cpu")
    assert wide.dtype == torch.int32
    assert torch.equal(wide, state[1].to(torch.int32))
    for bad in (8, -1):
        codes = ours._codes.astype(np.int64)
        codes[3, 2] = bad
        index = tcp.PQIndex(codes, ours._codebooks, 4, emb.shape[1] // 4,
                            emb.shape, device="cpu")
        with pytest.raises(ValueError, match=r"every code must lie in "
                                             r"\[0, 8\)"):
            index.search_batch(emb[:2], top_k=3, backend="device")


# ----------------------------------------------------------------- community
@pytest.fixture(scope="module")
def community_cases():
    """(JAX graph, port graph, embeddings): one below the 2¹⁸ device gate
    (600 × 32) and one above it (3,000 × 100)."""
    small = _graphs(600, 1) + (_clustered(600, 32, 6, 2),)
    big = _graphs(3000, 4) + (_clustered(3000, 100, 8, 5),)
    assert 600 * 32 <= 1 << 18 < 3000 * 100
    return {"below": small, "above": big}


@pytest.mark.parametrize("case", ["below", "above"])
def test_communities_and_modularity_equal_jax(community_cases, case):
    ref, g, emb = community_cases[case]
    for k in (2, 8):
        got = tcom.detect_communities_kmeans(g, emb, k, device="cpu")
        assert got == jcom.detect_communities_kmeans(ref, emb, k)
    got = tcom.detect_communities_spectral(g, emb, 5, device="cpu")
    assert got == jcom.detect_communities_spectral(ref, emb, 5)
    louvain = tcom.detect_communities_louvain(g)
    assert louvain == jcom.detect_communities_louvain(ref)
    assert tcom.modularity(g, louvain) == jcom.modularity(ref, louvain)
    assert tcom.modularity(g, got) == jcom.modularity(ref, got)


def test_community_gate_and_errors(community_cases):
    ref, g, emb = community_cases["below"]
    for k in (1, 999):
        with pytest.raises(ValueError) as want:
            jcom.detect_communities_kmeans(ref, emb, k)
        with pytest.raises(ValueError) as got:
            tcom.detect_communities_kmeans(g, emb, k)
        assert str(got.value) == str(want.value)
    if torch.cuda.is_available():
        return
    # below the gate the assignment stays numpy and needs no device; above
    # it, without a card and without device="cpu", it raises
    tcom.detect_communities_kmeans(g, emb, 3)
    _, big, emb_big = community_cases["above"]
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        tcom.detect_communities_kmeans(big, emb_big, 3)


def test_toolkit_on_the_cpu_launches_no_kernel(setup):
    _, g, emb = setup
    kernels.reset_launches()
    pq = tcp.product_quantize(emb, num_subspaces=4, num_centroids=8,
                              max_iter=2, seed=0, device="cpu")
    pq.search_batch(emb[:3], backend="device")
    tsearch.ANNIndex(g, emb, method="device", device="cpu").query_batch(
        emb[:3])
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)
