"""The port's host toolkit (copies and wrappers of JAX-free modules) against
the JAX package's originals, on the CPU.

Each case calls one function of both packages on the same seeded input.

- Exactly equal: the built-in graphs and ``load_dataset`` of them, the
  synthetic generators of ``datasets`` and ``generators``, ``stats``,
  ``sampling`` and the integer outputs of ``metrics``: the same numpy code.
- Float tolerance (rtol=1e-9): the float outputs of ``metrics``, ``align``,
  ``ensemble`` and ``viz`` (the same numpy code, which may reach another
  BLAS path in another process).
- By Gram matrix (atol=2e-5 on X·Xᵀ of unit rows, or of whitened rows
  divided by their width: eigenvector signs are free) or by equal scores: the wrappers over ``embed`` and
  ``SparseMatrix`` (``hetero``, ``tuning``, ``benchmark``, ``preprocess``,
  ``io_utils``), the port on ``device="cpu"``.
- BASELINE config 4 at the size of scripts/e2e_configs.py: link-prediction
  AUC within 0.02 of the JAX package's.

No case downloads anything or reads outside a temporary directory.
"""

import numpy as np
import pytest

import cleora_tpu as ct
import cleora_tpu_torch as ctt
from cleora_tpu import (
    align as jalign,
    benchmark as jbench,
    datasets as jds,
    ensemble as jens,
    generators as jgen,
    hetero as jhet,
    io_utils as jio,
    metrics as jmet,
    preprocess as jpre,
    sampling as jsamp,
    stats as jstats,
    tuning as jtun,
    viz as jviz,
)
from cleora_tpu_torch import (
    align as talign,
    benchmark as tbench,
    datasets as tds,
    ensemble as tens,
    generators as tgen,
    hetero as thet,
    io_utils as tio,
    metrics as tmet,
    preprocess as tpre,
    sampling as tsamp,
    stats as tstats,
    tuning as ttun,
    viz as tviz,
)
from torch_test_support import one_torch_thread  # noqa: F401


def _same(a, b, rtol=0.0):
    """Recursive equality; floats and float arrays within ``rtol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k], rtol)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, rtol)
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
        else:
            assert np.array_equal(a, b)
    elif isinstance(a, float):
        assert isinstance(b, float) and (
            a == b or abs(a - b) <= rtol * max(abs(a), abs(b))), (a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("datasets"))
    saved = [(m, m._CACHE_DIR, m._COMPAT_CACHE_DIR) for m in (jds, tds)]
    for m in (jds, tds):
        m._CACHE_DIR = path
        m._COMPAT_CACHE_DIR = path
    yield path
    for m, a, b in saved:
        m._CACHE_DIR, m._COMPAT_CACHE_DIR = a, b


@pytest.fixture(scope="module")
def karate(cache):
    d = jds.load_dataset("karate_club")
    ref = ct.SparseMatrix.from_iterator(iter(d["edges"]), d["columns"])
    g = ctt.SparseMatrix.from_iterator(iter(d["edges"]), d["columns"])
    emb = np.asarray(ct.embed(ref, feature_dim=16, num_iterations=6))
    return ref, g, emb, d["labels"]


# ---------------------------------------------------------------- datasets
@pytest.mark.parametrize("name", ["karate_club", "dolphins", "les_miserables",
                                  "football"])
def test_builtin_graphs_are_equal(cache, name):
    _same(tds.load_dataset(name), jds.load_dataset(name))


def test_dataset_registry_is_equal():
    _same(tds.list_datasets(), jds.list_datasets())


@pytest.mark.parametrize("case", ["citation", "product", "community"])
def test_synthetic_generators_are_equal(case):
    if case == "citation":
        (te, tl, tf), (je, jl, jf) = (m._citation_graph("cora", 7)
                                      for m in (tds, jds))
        assert te == je and tl == jl and tf.tobytes() == jf.tobytes()
        return
    if case == "product":
        args = (600, 2_000, 5, 3)
        t, j = tds._product_graph(*args), jds._product_graph(*args)
    else:
        args = (800, 3_000, 6, 4, 0.6)
        t, j = tds._community_graph(*args), jds._community_graph(*args)
    assert t[0] == j[0]
    _same(tuple(np.asarray(x) for x in t[1:]),
          tuple(np.asarray(x) for x in j[1:]))


def test_one_cache_serves_both_packages(cache):
    written = jds.load_dataset("citeseer")  # generated, cached by JAX's copy
    read = tds.load_dataset("citeseer")  # read back by the port's
    _same({k: v for k, v in read.items() if k != "features"},
          {k: v for k, v in written.items() if k != "features"})
    assert read["features"].tobytes() == written["features"].tobytes()


# -------------------------------------------------------------- generators
@pytest.mark.parametrize("fn,kw", [
    ("erdos_renyi", dict(num_nodes=60, p=0.1, seed=3)),
    ("erdos_renyi", dict(num_nodes=40, p=0.2, seed=4, directed=True)),
    ("barabasi_albert", dict(num_nodes=80, m=3, seed=5)),
    ("stochastic_block_model", dict(block_sizes=[20, 30, 25], seed=6)),
    ("planted_partition", dict(num_communities=3, community_size=15, seed=7)),
    ("watts_strogatz", dict(num_nodes=50, k=4, beta=0.3, seed=8)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_generators_are_equal(fn, kw):
    _same(getattr(tgen, fn)(**kw), getattr(jgen, fn)(**kw))


# ------------------------------------------------------------------- stats
@pytest.mark.parametrize("fn,kw", [
    ("degree_distribution", {}), ("clustering_coefficient", {}),
    ("connected_components", {}), ("diameter", {}),
    ("betweenness_centrality", {"top_k": 5}), ("pagerank", {"top_k": 5}),
    ("graph_summary", {"top_k": 3}),
])
def test_stats_are_equal(karate, fn, kw):
    ref, g, _, _ = karate
    _same(getattr(tstats, fn)(g, **kw), getattr(jstats, fn)(ref, **kw))


# ---------------------------------------------------------------- sampling
@pytest.mark.parametrize("fn,args", [
    ("sample_nodes", (10,)), ("sample_edges", (12,)),
    ("sample_neighborhood", (["0", "33"], 2, 3)),
    ("sample_subgraph", (12, "random_walk", 20)),
    ("sample_subgraph", (12, "random_node")),
    ("sample_subgraph", (12, "bfs")),
    ("graphsaint_sample", (8, 3, 2)), ("negative_sampling", (30,)),
    ("train_test_split_edges", (0.25,)),
])
def test_sampling_is_equal(karate, fn, args):
    ref, g, _, _ = karate
    _same(getattr(tsamp, fn)(g, *args), getattr(jsamp, fn)(ref, *args))


# ----------------------------------------------------------------- metrics
def _metric_cases():
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(60, 8))
    labels = rng.integers(0, 3, 60)
    other = rng.integers(0, 4, 60)
    return {
        "clustering_scores": lambda m, ref, g, e, l: m.clustering_scores(
            emb, labels),
        "adjusted_rand_index": lambda m, ref, g, e, l: m.adjusted_rand_index(
            labels, other),
        "silhouette_score": lambda m, ref, g, e, l: m.silhouette_score(
            emb, labels),
        "normalized_mutual_info": lambda m, ref, g, e, l:
            m._normalized_mutual_info(labels, other, 4),
        "node_classification_scores": lambda m, ref, g, e, l:
            m.node_classification_scores(g, e, l),
        "cross_validate": lambda m, ref, g, e, l: m.cross_validate(
            g, e, l, k_folds=3),
        "link_prediction_scores": lambda m, ref, g, e, l:
            m.link_prediction_scores(g, e, [("0", "1"), ("2", "3"),
                                            ("32", "33")], None, 5),
        "map_at_k": lambda m, ref, g, e, l: m.map_at_k(
            g, e, [("0", "1"), ("33", "32")], 5),
        "ndcg_at_k": lambda m, ref, g, e, l: m.ndcg_at_k(
            g, e, [("0", "1"), ("33", "32")], 5),
    }


@pytest.mark.parametrize("name", list(_metric_cases()))
def test_metrics_are_equal(karate, name):
    ref, g, emb, labels = karate
    call = _metric_cases()[name]
    _same(call(tmet, ref, g, emb, labels), call(jmet, ref, ref, emb, labels),
          rtol=1e-9)


# ------------------------------------------------- align, ensemble, viz
def _two(seed, n=50, d=6):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return a, (a @ q + 0.05 * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("case", [
    "procrustes", "cca_align", "alignment_score", "concat", "mean",
    "weighted", "svd", "pca", "tsne",
])
def test_align_ensemble_viz_are_equal(case):
    a, b = _two(12)
    calls = {
        "procrustes": lambda al, en, vz: al.procrustes(a, b),
        "cca_align": lambda al, en, vz: al.cca_align(a, b, 3),
        "alignment_score": lambda al, en, vz: al.alignment_score(a, b),
        "concat": lambda al, en, vz: en.combine([a, b], "concat"),
        "mean": lambda al, en, vz: en.combine([a, b], "mean"),
        "weighted": lambda al, en, vz: en.combine([a, b], "weighted",
                                                  [0.3, 0.7]),
        "svd": lambda al, en, vz: en.combine([a, b], "svd", target_dim=4),
        "pca": lambda al, en, vz: vz.reduce_dimensions(a, "pca", 2),
        "tsne": lambda al, en, vz: vz.reduce_dimensions(a[:30], "tsne", 2),
    }
    _same(calls[case](talign, tens, tviz), calls[case](jalign, jens, jviz),
          rtol=1e-9)


# ---------------------------------------------------------------- wrappers
def _gram(x, scale=1.0):
    x = np.asarray(x, dtype=np.float64)
    return x @ x.T / scale


def _hetero(mod):
    rng = np.random.default_rng(5)
    h = mod.HeteroGraph()
    h.add_node_type("user")
    h.add_node_type("item")
    pairs = [(f"u{rng.integers(0, 30)}", f"i{rng.integers(0, 15)}")
             for _ in range(200)]
    h.add_edge_type("buys", "user", "item", pairs[:120])
    h.add_edge_type("views", "user", "item", pairs[120:])
    h.add_edge_type("likes", "item", "user", [(i, u) for u, i in pairs[:60]])
    return h


def _stub_embed(calls):
    """A deterministic stand-in for ``embed``: the graph's hash init, so
    that ``hetero``'s own logic is compared exactly (the real embed is
    compared by Gram in the config 4 case)."""
    def embed(graph, feature_dim, **kw):
        calls.append(kw.get("device"))
        return graph.initialize_deterministically(feature_dim, kw["seed"])
    return embed


@pytest.mark.parametrize("case", ["concat", "mean", "metapath"])
def test_hetero_is_equal(monkeypatch, case):
    calls = []
    monkeypatch.setattr(ctt, "embed", _stub_embed(calls))
    monkeypatch.setattr(ct, "embed", _stub_embed([]))
    kw = dict(feature_dim=8, num_iterations=5, seed=3)
    if case == "metapath":
        tg, te = _hetero(thet).embed_metapath(["buys", "likes"], device="cpu",
                                              **kw)
        jg, je = _hetero(jhet).embed_metapath(["buys", "likes"], **kw)
        assert tg.entity_ids == jg.entity_ids
        _same(te, je)
    else:
        tg, te, tc = _hetero(thet).embed_per_relation(
            combine=case, device="cpu", **kw)
        jg, je, jc = _hetero(jhet).embed_per_relation(combine=case, **kw)
        assert [g.entity_ids for g in tg.values()] == \
            [g.entity_ids for g in jg.values()]
        _same(te, je)
        _same(tc, jc, rtol=1e-9)
    assert calls and set(calls) == {"cpu"}
    assert _hetero(thet).summary() == _hetero(jhet).summary()
    assert repr(_hetero(thet)) == repr(_hetero(jhet))


def test_tuning_finds_the_same_best_params(karate):
    ref, g, _, labels = karate
    # seeds only: every trial reuses the JAX program of the karate fixture
    grid = {"seed": [0, 1, 2]}

    def port(graph, **p):
        return ctt.embed(graph, feature_dim=16, num_iterations=6,
                         device="cpu", **p)

    def jax_embed(graph, **p):
        return ct.embed(graph, feature_dim=16, num_iterations=6, **p)

    t = ttun.grid_search(g, labels, port, grid)
    j = jtun.grid_search(ref, labels, jax_embed, grid)
    assert t["best_params"] == j["best_params"]
    assert [r["accuracy"] for r in t["all_results"]] == \
        [r["accuracy"] for r in j["all_results"]]
    dist = {"seed": (0, 9)}
    t = ttun.random_search(g, labels, port, dist, n_iter=3)
    j = jtun.random_search(ref, labels, jax_embed, dist, n_iter=3)
    assert [r["params"] for r in t["all_results"]] == \
        [r["params"] for r in j["all_results"]]


def test_benchmark_scores_and_tables(karate, cache):
    ref, g, emb, labels = karate
    t = tbench.benchmark_algorithms(g, labels, {
        "cleora": lambda x: ctt.embed(x, feature_dim=16, num_iterations=6,
                                      device="cpu"),
        "broken": lambda x: 1 / 0})
    # the JAX side's embedding is the karate fixture's, the same call
    j = jbench.benchmark_algorithms(ref, labels, {
        "cleora": lambda x: emb.copy(),
        "broken": lambda x: 1 / 0})
    _same(t["cleora"]["scores"], j["cleora"]["scores"], rtol=1e-9)
    assert t["broken"] == j["broken"]
    d = tds.load_dataset("karate_club")
    assert tbench.build_graph_for_dataset(d).entity_ids == \
        jbench.build_graph_for_dataset(d).entity_ids
    rows = {"a": {"avg_time": 1.5, "avg_memory_mb": 2.0,
                  "scores": {"accuracy": 0.75}}, "b": {"error": "x"}}
    assert tbench.format_benchmark_table(rows) == \
        jbench.format_benchmark_table(rows)
    assert tbench.format_dataset_table(rows) == \
        jbench.format_dataset_table(rows)


def test_preprocess_is_equal(karate):
    ref, g, _, _ = karate
    edges = ["a b", "b a", "c c", "a c", "d e", "a b"]
    assert tpre.clean_graph(edges, min_degree=2) == \
        jpre.clean_graph(edges, min_degree=2)
    assert tpre.filter_by_degree(g, 3, 10) == jpre.filter_by_degree(ref, 3, 10)
    split = ctt.SparseMatrix.from_iterator(
        iter(["a b", "b c", "x y"]), "complex::reflexive::node")
    jsplit = ct.SparseMatrix.from_iterator(
        iter(["a b", "b c", "x y"]), "complex::reflexive::node")
    t, j = (tpre.largest_connected_component(split),
            jpre.largest_connected_component(jsplit))
    assert isinstance(t, ctt.SparseMatrix)
    assert t.entity_ids == j.entity_ids


def test_io_utils_are_equal(karate, tmp_path):
    ref, g, emb, _ = karate
    assert tio.to_edge_list(g) == jio.to_edge_list(ref)
    adj = np.zeros((5, 5))
    adj[0, 1] = adj[2, 3] = adj[4, 0] = 1
    import scipy.sparse

    for make in (lambda m: m.from_numpy(adj),
                 lambda m: m.from_scipy_sparse(scipy.sparse.csr_matrix(adj)),
                 lambda m: m.from_edge_list([("a", "b"), ("b", "c", 2.0)]),
                 lambda m: m.from_networkx(jio.to_networkx(ref))):
        t, j = make(tio), make(jio)
        assert isinstance(t, ctt.SparseMatrix) and t.entity_ids == j.entity_ids
    for fmt in ("npz", "csv", "tsv"):
        path = str(tmp_path / f"e.{fmt}")
        tio.save_embeddings(g, emb, path, fmt)
        got = tio.load_embeddings(path, fmt)
        want = jio.load_embeddings(path, fmt)
        np.testing.assert_array_equal(got[0], want[0])
        assert list(got[1]) == list(want[1]) == g.entity_ids


def test_baseline_config_4_link_prediction(cache):
    """scripts/e2e_configs.py:75-120, the port on the CPU against the JAX
    package: per-relation embeds, an 80/20 edge split, Cleora + ProNE
    concatenated, link-prediction AUC."""
    def run(pkg, het, samp, ens, met, **dev):
        rng = np.random.default_rng(5)
        h = het.HeteroGraph()
        h.add_node_type("user")
        h.add_node_type("item")

        def biased_pair():
            group = rng.integers(0, 5)
            u = group * 40 + rng.integers(0, 40)
            if rng.random() < 0.85:
                i = group * 20 + rng.integers(0, 20)
            else:
                i = rng.integers(0, 100)
            return f"u{u}", f"i{i}"

        h.add_edge_type("buys", "user", "item",
                        [biased_pair() for _ in range(2000)])
        h.add_edge_type("views", "user", "item",
                        [biased_pair() for _ in range(3000)])
        per = h.embed_per_relation(feature_dim=64, num_iterations=10, **dev)
        g = pkg.SparseMatrix.from_iterator(iter(h.to_homogeneous_edges()),
                                           "complex::reflexive::node")
        split = samp.train_test_split_edges(g, test_ratio=0.2)
        train_g = pkg.SparseMatrix.from_iterator(
            iter(split["train_edge_strings"]), "complex::reflexive::node")
        cleora = pkg.embed(train_g, feature_dim=64, num_iterations=10,
                           whiten=False, **dev)
        prone = pkg.algorithms.embed_prone(train_g, feature_dim=64)
        combo = ens.combine([cleora, prone], method="concat")
        known = set(train_g.entity_ids)
        test = [(a, b) for a, b in split["test_edges"]
                if a in known and b in known]
        return per, met.link_prediction_scores(train_g, combo, test)

    import cleora_tpu.algorithms  # noqa: F401
    import cleora_tpu_torch.algorithms  # noqa: F401

    (tg, te, tc), ours = run(ctt, thet, tsamp, tens, tmet, device="cpu")
    (jg, je, jc), theirs = run(ct, jhet, jsamp, jens, jmet)
    for k in tg:  # the per-relation embeds and their concatenation
        assert tg[k].entity_ids == jg[k].entity_ids
        # whitened rows: the Gram per dimension (its entries are O(1))
        np.testing.assert_allclose(_gram(te[k], 64), _gram(je[k], 64),
                                   atol=2e-5)
    np.testing.assert_allclose(_gram(tc), _gram(jc), atol=2e-5)  # unit rows
    assert abs(ours["auc"] - theirs["auc"]) <= 0.02, (ours, theirs)
