"""Dataset registry: 25 graph datasets with the reference's exact semantics.

Three kinds (reference: pycleora/datasets.py):

1. built-in small graphs (karate_club, dolphins, les_miserables, football) —
   published datasets shipped as data in cleora_tpu_torch/data/builtin_graphs.json;
2. synthetic stand-ins matching published node/edge/class counts
   (cora/citeseer/pubmed via the citation generator, amazon_*/ppi/reddit via
   the product generator, dblp, and ogbn_arxiv/flickr/ppi_large/yelp via the
   batched community generator).  The RNG call sequences replicate the
   reference generators bit-for-bit (same seeds, same draw order), because
   the published accuracy baselines (BASELINE.md) are measured on these;
3. real downloads: SNAP edge lists and OGB zips, streamed + .npz-cached with
   the same edge-count drift validation (>20% ⇒ error).

Every loader returns a dict with keys: name, edges, labels, num_nodes,
num_edges, num_classes, columns, description (+features for citation sets).

A copy of cleora_tpu/datasets.py (numpy only), held equal to it by
tests/test_torch_host_modules.py.  It reads and writes the same cache
(``CLEORA_TPU_CACHE``, else ``~/.cleora_tpu_datasets``) in the same layout, so
one cache serves both packages.
"""

from __future__ import annotations

import gzip
import json
import os
import sys
from collections.abc import Sequence
from typing import Dict, List, Optional

import numpy as np

_CACHE_DIR = os.environ.get(
    "CLEORA_TPU_CACHE", os.path.join(os.path.expanduser("~"), ".cleora_tpu_datasets")
)
# reuse already-downloaded caches from the reference install, if any
_COMPAT_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".pycleora_datasets")

_DATA_JSON = os.path.join(os.path.dirname(__file__), "data", "builtin_graphs.json")


class _LazyEdgeList(Sequence):
    """Read-only sequence view rendering parallel (src, dst) id arrays
    as ``"src dst"`` strings on access, so the big SNAP edge lists live
    as two int arrays instead of hundreds of millions of Python strings
    (capability parity with reference datasets.py:12-39; the rendering
    here is chunked-vectorized — one ``np.char`` join per 64k block on
    iteration, which is where the graph builders consume it)."""

    __slots__ = ("_pairs",)
    _CHUNK = 1 << 16

    def __init__(self, src: np.ndarray, dst: np.ndarray):
        if len(src) != len(dst):
            raise ValueError("src/dst length mismatch")
        self._pairs = (src, dst)

    def __len__(self):
        return len(self._pairs[0])

    def _render(self, lo: int, hi: int):
        src, dst = self._pairs
        left = np.char.add(src[lo:hi].astype(str), " ")
        return np.char.add(left, dst[lo:hi].astype(str)).tolist()

    def __getitem__(self, idx):
        n = len(self)
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(n))]
        i = int(idx)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"index {i} out of range")
        src, dst = self._pairs
        return f"{src[i]} {dst[i]}"

    def __iter__(self):
        for lo in range(0, len(self), self._CHUNK):
            yield from self._render(lo, min(lo + self._CHUNK, len(self)))

    def __repr__(self):
        return f"_LazyEdgeList(len={len(self):,})"

    def arrays(self):
        """(src, dst) integer arrays — the zero-copy fast path for ingest."""
        return self._pairs


# --------------------------------------------------------------------- cache
def _cache_path(name: str, suffix: str = ".npz") -> str:
    os.makedirs(_CACHE_DIR, exist_ok=True)
    ours = os.path.join(_CACHE_DIR, name + suffix)
    if not os.path.exists(ours):
        theirs = os.path.join(_COMPAT_CACHE_DIR, name + suffix)
        if os.path.exists(theirs):
            return theirs
    return ours


def _atomic_savez(path: str, **arrays):
    import tempfile

    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.rename(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _download(url: str, filepath: str, description: str = "Downloading"):
    import ssl
    import urllib.request

    ctx = ssl.create_default_context()
    req = urllib.request.Request(url)
    with urllib.request.urlopen(req, context=ctx) as response, open(
        filepath, "wb"
    ) as f:
        total = response.headers.get("Content-Length")
        total = int(total) if total else None
        done = 0
        while True:
            chunk = response.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
            done += len(chunk)
            mb = done / (1 << 20)
            if total:
                sys.stderr.write(
                    f"\r{description}: {mb:.1f}/{total / (1 << 20):.1f} MB "
                    f"({done / total * 100:.1f}%)"
                )
            else:
                sys.stderr.write(f"\r{description}: {mb:.1f} MB")
            sys.stderr.flush()
    sys.stderr.write("\n")


def _fetch(url: str, path: str, display_name: str):
    tmp = path + ".tmp"
    if not os.path.exists(path):
        _download(url, tmp, description=f"Downloading {display_name}")
        os.rename(tmp, path)


def _seed_path(*names: str) -> Optional[str]:
    """First existing pre-seeded file among ``names`` in the cache dir (or
    the reference install's compat cache).  Lets a zero-egress environment
    run the SNAP configs from manually copied files: e.g. seed
    ``~/.cleora_tpu_datasets/facebook.txt.gz`` with SNAP's
    facebook_combined.txt.gz and ``load_dataset("facebook")`` never touches
    the network."""
    for d in (_CACHE_DIR, _COMPAT_CACHE_DIR):
        for name in names:
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
    return None


def snap_cache_status(name: str) -> Optional[str]:
    """Path of the local data that lets ``load_dataset(name)`` run without
    network (parsed .npz cache or a pre-seeded raw edge list), or None."""
    return _seed_path(name + ".npz", name + ".txt.gz", name + ".txt")


# ------------------------------------------------------------- built-in data
def _load_builtin(key: str) -> Dict:
    with open(_DATA_JSON) as f:
        d = json.load(f)[key]
    d["labels"] = {k: int(v) for k, v in d["labels"].items()}
    return d


# -------------------------------------------------------- synthetic: citation
_CITATION_SHAPES = {
    "cora": (2708, 5429, 1433),
    "citeseer": (3312, 4732, 3703),
    "pubmed": (19717, 44338, 500),
}


def _citation_graph(name: str, num_classes: int, seed: int = 42):
    """Community-biased random citation graph; RNG stream identical to the
    reference generator (datasets.py:666-719): 70% intra-class edges, Poisson
    per-node neighbor counts, fill-up loop, then Gaussian features with a +2
    bump on the class coordinate."""
    n, target_edges, feat_dim = _CITATION_SHAPES[name]
    rng = np.random.default_rng(seed)

    community = rng.integers(0, num_classes, size=n)
    members = [np.flatnonzero(community == c) for c in range(num_classes)]
    labels = {f"p{i}": int(community[i]) for i in range(n)}

    edge_set = set()
    for i in range(n):
        k = int(rng.poisson(lam=target_edges * 2 / n))
        k = max(1, min(k, 20))
        for _ in range(k):
            if rng.random() < 0.7:
                j = int(rng.choice(members[community[i]]))
            else:
                j = int(rng.integers(0, n))
            if i != j:
                edge_set.add((min(i, j), max(i, j)))
            if len(edge_set) >= target_edges:
                break
        if len(edge_set) >= target_edges:
            break
    while len(edge_set) < target_edges:
        i = int(rng.integers(0, n))
        j = int(rng.integers(0, n))
        if i != j:
            edge_set.add((min(i, j), max(i, j)))

    edges = [f"p{i} p{j}" for i, j in edge_set]
    features = rng.standard_normal((n, min(feat_dim, 64))).astype(np.float32)
    width = features.shape[1]
    for i in range(n):
        features[i, community[i] % width] += 2.0
    return edges, labels, features


def _load_citation(name: str, display_name: str, description: str,
                   num_classes: int) -> Dict:
    path = _cache_path(name)
    if os.path.exists(path):
        d = np.load(path, allow_pickle=True)
        return {
            "name": display_name,
            "edges": d["edges"].tolist(),
            "labels": dict(zip(d["label_keys"].tolist(),
                               (int(v) for v in d["label_vals"]))),
            "num_nodes": int(d["num_nodes"]),
            "num_edges": int(d["num_edges"]),
            "num_classes": int(d["num_classes"]),
            "columns": "complex::reflexive::paper",
            "description": description,
            "features": d["features"] if "features" in d else None,
        }

    edges, labels, features = _citation_graph(name, num_classes)
    _atomic_savez(
        path,
        edges=np.array(edges),
        label_keys=np.array(list(labels.keys())),
        label_vals=np.array(list(labels.values())),
        num_nodes=len(labels),
        num_edges=len(edges),
        num_classes=num_classes,
        features=features,
    )
    return {
        "name": display_name,
        "edges": edges,
        "labels": labels,
        "num_nodes": len(labels),
        "num_edges": len(edges),
        "num_classes": num_classes,
        "columns": "complex::reflexive::paper",
        "description": description,
        "features": features,
    }


# --------------------------------------------------------- synthetic: product
def _product_graph(num_nodes: int, num_edges: int, num_classes: int, seed: int):
    """65%-intra community product graph; RNG stream identical to the
    reference (datasets.py:745-806)."""
    rng = np.random.default_rng(seed)
    community = rng.integers(0, num_classes, size=num_nodes)
    members = [np.flatnonzero(community == c) for c in range(num_classes)]
    labels = {f"prod{i}": int(community[i]) for i in range(num_nodes)}

    edge_set = set()
    for i in range(num_nodes):
        k = int(rng.poisson(lam=num_edges * 2 / num_nodes))
        k = max(1, min(k, 50))
        for _ in range(k):
            if rng.random() < 0.65:
                j = int(rng.choice(members[community[i]]))
            else:
                j = int(rng.integers(0, num_nodes))
            if i != j:
                edge_set.add((min(i, j), max(i, j)))
            if len(edge_set) >= num_edges:
                break
        if len(edge_set) >= num_edges:
            break
    while len(edge_set) < num_edges:
        i, j = int(rng.integers(0, num_nodes)), int(rng.integers(0, num_nodes))
        if i != j:
            edge_set.add((min(i, j), max(i, j)))

    edges = [f"prod{i} prod{j}" for i, j in edge_set]
    return edges, labels


def _load_product(name: str, display_name: str, description: str, *,
                  num_nodes: int, num_edges: int, num_classes: int,
                  seed: int) -> Dict:
    path = _cache_path(name)
    if os.path.exists(path):
        d = np.load(path, allow_pickle=True)
        return {
            "name": display_name,
            "edges": d["edges"].tolist(),
            "labels": dict(zip(d["label_keys"].tolist(),
                               (int(v) for v in d["label_vals"]))),
            "num_nodes": int(d["num_nodes"]),
            "num_edges": int(d["num_edges"]),
            "num_classes": int(d["num_classes"]),
            "columns": "complex::reflexive::product",
            "description": description,
        }

    edges, labels = _product_graph(num_nodes, num_edges, num_classes, seed)
    _atomic_savez(
        path,
        edges=np.array(edges),
        label_keys=np.array(list(labels.keys())),
        label_vals=np.array(list(labels.values())),
        num_nodes=num_nodes,
        num_edges=len(edges),
        num_classes=num_classes,
    )
    return {
        "name": display_name,
        "edges": edges,
        "labels": labels,
        "num_nodes": num_nodes,
        "num_edges": len(edges),
        "num_classes": num_classes,
        "columns": "complex::reflexive::product",
        "description": description,
    }


# ------------------------------------------------------------ synthetic: dblp
def _load_dblp() -> Dict:
    description = "DBLP co-authorship network. 4 research areas."
    path = _cache_path("dblp")
    if os.path.exists(path):
        d = np.load(path, allow_pickle=True)
        return {
            "name": "DBLP",
            "edges": d["edges"].tolist(),
            "labels": dict(zip(d["label_keys"].tolist(),
                               (int(v) for v in d["label_vals"]))),
            "num_nodes": int(d["num_nodes"]),
            "num_edges": int(d["num_edges"]),
            "num_classes": int(d["num_classes"]),
            "columns": "complex::reflexive::author",
            "description": description,
            "is_heterogeneous": True,
            "edge_types": d["edge_types"].tolist() if "edge_types" in d else None,
        }

    # RNG-stream parity with the reference (datasets.py:823-886)
    rng = np.random.default_rng(400)
    num_authors, num_papers, num_classes = 4057, 14328, 4
    author_area = rng.integers(0, num_classes, size=num_authors)
    area_members = [np.flatnonzero(author_area == a) for a in range(num_classes)]
    labels = {f"author{i}": int(author_area[i]) for i in range(num_authors)}

    coauthor = set()
    author_paper = []
    for p in range(num_papers):
        area = int(rng.integers(0, num_classes))
        same = area_members[area]
        k = int(rng.integers(2, 5))
        pool = same if len(same) >= k else num_authors
        authors = rng.choice(pool, size=k, replace=False)
        for a in authors:
            author_paper.append(f"author{a} paper{p}")
        for i in range(len(authors)):
            for j in range(i + 1, len(authors)):
                a1, a2 = int(authors[i]), int(authors[j])
                coauthor.add((min(a1, a2), max(a1, a2)))

    edges = [f"author{i} author{j}" for i, j in coauthor]
    _atomic_savez(
        path,
        edges=np.array(edges),
        label_keys=np.array(list(labels.keys())),
        label_vals=np.array(list(labels.values())),
        num_nodes=num_authors,
        num_edges=len(edges),
        num_classes=num_classes,
        edge_types=np.array(author_paper),
    )
    return {
        "name": "DBLP",
        "edges": edges,
        "labels": labels,
        "num_nodes": num_authors,
        "num_edges": len(edges),
        "num_classes": num_classes,
        "columns": "complex::reflexive::author",
        "description": description,
        "is_heterogeneous": True,
        "edge_types": author_paper,
    }


# ------------------------------------------------------- synthetic: community
def _community_graph(num_nodes: int, num_edges: int, num_classes: int,
                     seed: int, intra_prob: float):
    """Batched community graph; RNG stream identical to the reference
    (datasets.py:893-970): per batch draw all sources + intra flags at once,
    then resolve targets one by one."""
    rng = np.random.default_rng(seed)
    community = rng.integers(0, num_classes, size=num_nodes)
    members = {c: np.flatnonzero(community == c) for c in range(num_classes)}

    edge_set = set()
    batch = max(num_edges // 20, 100_000)
    while len(edge_set) < num_edges:
        remaining = num_edges - len(edge_set)
        gen_count = min(remaining * 2, batch * 2)
        srcs = rng.integers(0, num_nodes, size=gen_count)
        is_intra = rng.random(size=gen_count) < intra_prob
        for k in range(gen_count):
            i = int(srcs[k])
            if is_intra[k]:
                m = members[community[i]]
                j = int(m[rng.integers(0, len(m))])
            else:
                j = int(rng.integers(0, num_nodes))
            if i != j:
                edge_set.add((min(i, j), max(i, j)))
            if len(edge_set) >= num_edges:
                break
    return edge_set, community


def _load_community(name: str, display_name: str, description: str, *,
                    num_nodes: int, num_edges: int, num_classes: int,
                    columns: str, seed: int, intra_prob: float = 0.6) -> Dict:
    path = _cache_path(name)
    if os.path.exists(path):
        d = np.load(path, allow_pickle=True)
        return {
            "name": display_name,
            "edges": d["edges"].tolist(),
            "labels": dict(zip(d["label_keys"].tolist(),
                               (int(v) for v in d["label_vals"]))),
            "num_nodes": int(d["num_nodes"]),
            "num_edges": int(d["num_edges"]),
            "num_classes": int(d["num_classes"]),
            "columns": columns,
            "description": description,
        }

    sys.stderr.write(
        f"Generating {display_name} ({num_nodes:,} nodes, {num_edges:,} edges)...\n"
    )
    edge_set, community = _community_graph(
        num_nodes, num_edges, num_classes, seed, intra_prob
    )
    prefix = name.replace("_", "")[:3]
    edges = [f"{prefix}{i} {prefix}{j}" for i, j in edge_set]
    labels = {f"{prefix}{i}": int(community[i]) for i in range(num_nodes)}
    _atomic_savez(
        path,
        edges=np.array(edges),
        label_keys=np.array(list(labels.keys())),
        label_vals=np.array(list(labels.values())),
        num_nodes=num_nodes,
        num_edges=len(edges),
        num_classes=num_classes,
    )
    return {
        "name": display_name,
        "edges": edges,
        "labels": labels,
        "num_nodes": num_nodes,
        "num_edges": len(edges),
        "num_classes": num_classes,
        "columns": columns,
        "description": description,
    }


# -------------------------------------------------------------- SNAP download
def _load_snap(name: str, url: str, display_name: str, description: str, *,
               expected_nodes: int, expected_edges: int,
               size_warning: Optional[str] = None,
               columns: str = "complex::reflexive::node") -> Dict:
    path = _cache_path(name)
    if os.path.exists(path):
        d = np.load(path, allow_pickle=False)
        return {
            "name": display_name,
            "edges": _LazyEdgeList(d["src"], d["dst"]),
            "labels": {},
            "num_nodes": int(d["num_nodes"]),
            "num_edges": int(d["num_edges"]),
            "num_classes": 0,
            "columns": columns,
            "description": description,
        }

    if size_warning:
        sys.stderr.write(f"WARNING: {size_warning}\n")
    raw_path = _seed_path(f"{name}.txt.gz", f"{name}.txt")
    downloaded = raw_path is None
    if downloaded:
        raw_path = os.path.join(_CACHE_DIR, f"{name}.txt.gz")
        _fetch(url, raw_path, display_name)

    sys.stderr.write(f"Parsing {display_name} edges (streaming)...\n")
    dtype = np.int64 if expected_nodes > np.iinfo(np.int32).max else np.int32
    opener = gzip.open if raw_path.endswith(".gz") else open
    with opener(raw_path, "rt", encoding="utf-8") as f:
        src, dst = _parse_int_pairs(f, dtype, sep=None)

    num_nodes = len(np.union1d(np.unique(src), np.unique(dst))) if len(src) else 0
    num_edges = len(src)
    drift = abs(num_edges - expected_edges) / max(expected_edges, 1)
    if drift > 0.20:
        raise ValueError(
            f"{display_name}: parsed {num_edges:,} edges but expected "
            f"~{expected_edges:,} (drift {drift:.1%}). The download may be "
            f"corrupt. Delete {raw_path} and retry."
        )
    if drift > 0.01 or num_nodes != expected_nodes:
        sys.stderr.write(
            f"  Note: parsed {num_nodes:,} nodes / {num_edges:,} edges "
            f"(expected ~{expected_nodes:,} / ~{expected_edges:,})\n"
        )

    _atomic_savez(path, src=src, dst=dst, num_nodes=num_nodes, num_edges=num_edges)
    if downloaded:  # keep pre-seeded raw files; remove only our download
        try:
            os.remove(raw_path)
        except OSError:
            pass
    return {
        "name": display_name,
        "edges": _LazyEdgeList(src, dst),
        "labels": {},
        "num_nodes": num_nodes,
        "num_edges": num_edges,
        "num_classes": 0,
        "columns": columns,
        "description": description,
    }


def _parse_int_pairs(stream, dtype, sep=None):
    """Stream 'src sep dst' lines into chunked int arrays, skipping comments."""
    chunk_size = 1_000_000
    src_chunks, dst_chunks = [], []
    sbuf = np.empty(chunk_size, dtype=dtype)
    dbuf = np.empty(chunk_size, dtype=dtype)
    k = 0
    count = 0
    for line in stream:
        if not line or line[0] in "#\n":
            continue
        parts = line.split(sep)
        if len(parts) < 2:
            continue
        try:
            s, t = int(parts[0]), int(parts[1])
        except ValueError:
            continue
        sbuf[k] = s
        dbuf[k] = t
        k += 1
        count += 1
        if k == chunk_size:
            src_chunks.append(sbuf[:k].copy())
            dst_chunks.append(dbuf[:k].copy())
            k = 0
            if count % 5_000_000 == 0:
                sys.stderr.write(f"\r  Parsed {count:,} edges...")
                sys.stderr.flush()
    if k:
        src_chunks.append(sbuf[:k].copy())
        dst_chunks.append(dbuf[:k].copy())
    src = np.concatenate(src_chunks) if src_chunks else np.array([], dtype=dtype)
    dst = np.concatenate(dst_chunks) if dst_chunks else np.array([], dtype=dtype)
    return src, dst


# --------------------------------------------------------------- OGB download
def _load_ogb(name: str, display_name: str, description: str, *, zip_url: str,
              edge_csv: str, expected_nodes: int, expected_edges: int,
              label_csv: Optional[str] = None, num_classes: int = 0,
              columns: str = "complex::reflexive::node") -> Dict:
    import io
    import zipfile

    path = _cache_path(name)
    if os.path.exists(path):
        d = np.load(path, allow_pickle=True)
        labels = {}
        if "label_keys" in d and "label_vals" in d:
            labels = dict(zip(d["label_keys"].tolist(), d["label_vals"].tolist()))
        return {
            "name": display_name,
            "edges": _LazyEdgeList(d["src"], d["dst"]),
            "labels": labels,
            "num_nodes": int(d["num_nodes"]),
            "num_edges": int(d["num_edges"]),
            "num_classes": num_classes,
            "columns": columns,
            "description": description,
        }

    zip_path = os.path.join(_CACHE_DIR, f"{name}.zip")
    _fetch(zip_url, zip_path, display_name)

    sys.stderr.write(f"Extracting {display_name} edges from zip...\n")
    dtype = np.int64 if expected_nodes > np.iinfo(np.int32).max else np.int32

    def open_member(zf, suffix):
        for member in zf.namelist():
            if member.endswith(suffix):
                handle = zf.open(member)
                if member.endswith(".gz"):
                    return gzip.open(handle, "rt", encoding="utf-8")
                return io.TextIOWrapper(handle, encoding="utf-8")
        raise KeyError(
            f"No zip member ending with '{suffix}'. Available: {zf.namelist()[:20]}"
        )

    labels = {}
    with zipfile.ZipFile(zip_path) as zf:
        with open_member(zf, edge_csv.split("/", 1)[-1]) as ef:
            src, dst = _parse_int_pairs(ef, dtype, sep=",")
        if label_csv:
            try:
                with open_member(zf, label_csv.split("/", 1)[-1]) as lf:
                    for node_id, line in enumerate(lf):
                        line = line.strip()
                        if line:
                            try:
                                labels[str(node_id)] = str(int(line.split(",")[0]))
                            except ValueError:
                                continue
            except (KeyError, FileNotFoundError):
                sys.stderr.write(
                    "  Warning: label file not found in zip, skipping labels.\n"
                )

    num_nodes = int(max(src.max(), dst.max())) + 1 if len(src) else 0
    save = dict(src=src, dst=dst, num_nodes=num_nodes, num_edges=len(src))
    if labels:
        save["label_keys"] = np.array(list(labels.keys()))
        save["label_vals"] = np.array(list(labels.values()))
    _atomic_savez(path, **save)
    try:
        os.remove(zip_path)
    except OSError:
        pass
    return {
        "name": display_name,
        "edges": _LazyEdgeList(src, dst),
        "labels": labels,
        "num_nodes": num_nodes,
        "num_edges": len(src),
        "num_classes": num_classes,
        "columns": columns,
        "description": description,
    }


# ----------------------------------------------------------- special loaders
def _load_reddit_hyperlink() -> Dict:
    """Reddit hyperlink TSV: string subreddit names → first-seen int ids."""
    import csv

    name = "reddit_hyperlink"
    display_name = "Reddit Hyperlink Network"
    description = (
        "Reddit hyperlink network (SNAP). Subreddits as nodes, hyperlinks "
        "between posts as edges. ~55K nodes, ~858K edges."
    )
    path = _cache_path(name)
    if os.path.exists(path):
        d = np.load(path, allow_pickle=False)
        return {
            "name": display_name,
            "edges": _LazyEdgeList(d["src"], d["dst"]),
            "labels": {},
            "num_nodes": int(d["num_nodes"]),
            "num_edges": int(d["num_edges"]),
            "num_classes": 0,
            "columns": "complex::reflexive::subreddit",
            "description": description,
        }

    url = "https://snap.stanford.edu/data/soc-redditHyperlinks-body.tsv"
    tsv_path = os.path.join(_CACHE_DIR, f"{name}.tsv")
    _fetch(url, tsv_path, display_name)

    sys.stderr.write(f"Parsing {display_name} edges from TSV...\n")
    node_map: Dict[str, int] = {}
    src_list, dst_list = [], []
    with open(tsv_path, "r", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t")
        next(reader, None)  # header
        for row in reader:
            if len(row) < 2:
                continue
            s = node_map.setdefault(row[0].strip(), len(node_map))
            t = node_map.setdefault(row[1].strip(), len(node_map))
            src_list.append(s)
            dst_list.append(t)
    src = np.array(src_list, dtype=np.int32)
    dst = np.array(dst_list, dtype=np.int32)
    num_nodes = len(node_map)
    _atomic_savez(path, src=src, dst=dst, num_nodes=num_nodes, num_edges=len(src))
    try:
        os.remove(tsv_path)
    except OSError:
        pass
    return {
        "name": display_name,
        "edges": _LazyEdgeList(src, dst),
        "labels": {},
        "num_nodes": num_nodes,
        "num_edges": len(src),
        "num_classes": 0,
        "columns": "complex::reflexive::subreddit",
        "description": description,
    }


def _load_twitter() -> Dict:
    import zipfile

    name = "twitter"
    display_name = "Twitter-2010"
    description = "Twitter-2010 follower network. ~41.7M users, ~1.47B edges."
    path = _cache_path(name)
    if os.path.exists(path):
        d = np.load(path, allow_pickle=False)
        return {
            "name": display_name,
            "edges": _LazyEdgeList(d["src"], d["dst"]),
            "labels": {},
            "num_nodes": int(d["num_nodes"]),
            "num_edges": int(d["num_edges"]),
            "num_classes": 0,
            "columns": "complex::reflexive::user",
            "description": description,
        }

    sys.stderr.write(
        "WARNING: Twitter-2010 is a very large dataset (~6GB compressed, "
        "~1.47B edges). Download and parsing may take a long time and require "
        "significant memory.\n"
    )
    zip_url = "https://nrvis.com/download/data/soc/soc-twitter.zip"
    zip_path = os.path.join(_CACHE_DIR, f"{name}.zip")
    _fetch(zip_url, zip_path, display_name)

    sys.stderr.write(f"Parsing {display_name} edges (streaming from zip)...\n")
    import io

    with zipfile.ZipFile(zip_path) as zf:
        member = zf.namelist()[0]
        with zf.open(member) as f:
            src, dst = _parse_int_pairs(
                io.TextIOWrapper(f, encoding="utf-8"), np.int32, sep=None
            )
    num_nodes = len(np.union1d(np.unique(src), np.unique(dst))) if len(src) else 0
    _atomic_savez(path, src=src, dst=dst, num_nodes=num_nodes, num_edges=len(src))
    try:
        os.remove(zip_path)
    except OSError:
        pass
    return {
        "name": display_name,
        "edges": _LazyEdgeList(src, dst),
        "labels": {},
        "num_nodes": num_nodes,
        "num_edges": len(src),
        "num_classes": 0,
        "columns": "complex::reflexive::user",
        "description": description,
    }


# -------------------------------------------------------------------- registry
def load_karate_club() -> Dict:
    return _load_builtin("karate_club")


def load_dolphins() -> Dict:
    return _load_builtin("dolphins")


def load_les_miserables() -> Dict:
    return _load_builtin("les_miserables")


def load_football() -> Dict:
    return _load_builtin("football")


def load_cora() -> Dict:
    return _load_citation(
        "cora", "Cora Dataset",
        "Citation network of ML papers. 2708 nodes, 5429 edges, 7 classes.",
        num_classes=7,
    )


def load_citeseer() -> Dict:
    return _load_citation(
        "citeseer", "CiteSeer Dataset",
        "Citation network of CS papers. 3312 nodes, 4732 edges, 6 classes.",
        num_classes=6,
    )


def load_pubmed() -> Dict:
    return _load_citation(
        "pubmed", "PubMed Diabetes Dataset",
        "Citation network of diabetes papers. 19717 nodes, 44338 edges, 3 classes.",
        num_classes=3,
    )


def load_amazon_computers() -> Dict:
    return _load_product(
        "amazon_computers", "Amazon Computers",
        "Amazon co-purchase graph for computers. Nodes are products, edges "
        "are co-purchases.",
        num_nodes=13752, num_edges=245861, num_classes=10, seed=100,
    )


def load_amazon_photo() -> Dict:
    return _load_product(
        "amazon_photo", "Amazon Photo",
        "Amazon co-purchase graph for photo products.",
        num_nodes=7650, num_edges=119081, num_classes=8, seed=200,
    )


def load_ppi() -> Dict:
    return _load_product(
        "ppi", "Protein-Protein Interaction",
        "PPI network with protein functions as labels.",
        num_nodes=3890, num_edges=76584, num_classes=50, seed=300,
    )


def load_dblp() -> Dict:
    return _load_dblp()


def load_reddit() -> Dict:
    return _load_product(
        "reddit", "Reddit",
        "Reddit post graph. Posts as nodes, shared commenters as edges.",
        num_nodes=10000, num_edges=100000, num_classes=41, seed=500,
    )


def _facebook_ego_labels() -> Dict[str, int]:
    """Ego-network-membership labels for ego-Facebook, derived from SNAP's
    per-ego archive when it has been seeded into the cache dir as
    ``facebook.tar.gz`` (the file at
    https://snap.stanford.edu/data/facebook.tar.gz, whose members are
    ``facebook/<ego>.edges`` etc.) or pre-extracted as a ``facebook/``
    subdirectory.  Each node is labeled by the ego network it appears in
    (class index = rank of the ego id among the 10 egos, sorted ascending);
    nodes in several ego networks take the lowest ego id; each ego node
    labels itself.  Returns {} when no archive is seeded."""
    labels: Dict[str, int] = {}
    per_ego: Dict[int, set] = {}

    subdir = _seed_path("facebook")
    if subdir is not None and os.path.isdir(subdir):
        for fname in os.listdir(subdir):
            if not fname.endswith(".edges"):
                continue
            ego = int(fname[:-len(".edges")])
            nodes = per_ego.setdefault(ego, {ego})
            with open(os.path.join(subdir, fname)) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        nodes.add(int(parts[0]))
                        nodes.add(int(parts[1]))
    else:
        tar_path = _seed_path("facebook.tar.gz", "facebook.tar")
        if tar_path is None:
            return {}
        import tarfile

        with tarfile.open(tar_path, "r:*") as tf:
            for member in tf:
                base = os.path.basename(member.name)
                if not (member.isfile() and base.endswith(".edges")):
                    continue
                ego = int(base[:-len(".edges")])
                nodes = per_ego.setdefault(ego, {ego})
                data = tf.extractfile(member).read().decode("utf-8")
                for line in data.splitlines():
                    parts = line.split()
                    if len(parts) >= 2:
                        nodes.add(int(parts[0]))
                        nodes.add(int(parts[1]))

    class_of = {ego: c for c, ego in enumerate(sorted(per_ego))}
    for ego in sorted(per_ego):  # lowest ego id wins for shared nodes
        for node in per_ego[ego]:
            labels.setdefault(str(node), class_of[ego])
    return labels


def load_facebook() -> Dict:
    out = _load_snap(
        "facebook", "https://snap.stanford.edu/data/facebook_combined.txt.gz",
        "ego-Facebook",
        "Facebook ego networks (SNAP). ~4k nodes, ~88k edges.",
        expected_nodes=4_039, expected_edges=88_234,
    )
    labels = _facebook_ego_labels()
    if labels:
        out["labels"] = labels
        out["num_classes"] = len(set(labels.values()))
    return out


def load_roadnet() -> Dict:
    return _load_snap(
        "roadnet", "https://snap.stanford.edu/data/roadNet-CA.txt.gz",
        "roadNet-CA",
        "California road network (SNAP). ~2M nodes, ~2.8M edges.",
        expected_nodes=1_965_206, expected_edges=5_533_214,
        size_warning="roadNet-CA is a large dataset (~12MB compressed, "
                     "~2.8M edges).",
    )


def load_livejournal() -> Dict:
    return _load_snap(
        "livejournal", "https://snap.stanford.edu/data/soc-LiveJournal1.txt.gz",
        "soc-LiveJournal1",
        "LiveJournal online social network (SNAP). ~4.8M nodes, ~69M edges.",
        expected_nodes=4_847_571, expected_edges=68_993_773,
        size_warning="soc-LiveJournal1 is a very large dataset (~250MB "
                     "compressed, ~69M edges). Download and parsing may take "
                     "a long time and require significant memory.",
    )


def load_com_orkut() -> Dict:
    return _load_snap(
        "com_orkut",
        "https://snap.stanford.edu/data/bigdata/communities/com-orkut.ungraph.txt.gz",
        "com-Orkut",
        "Orkut online social network (SNAP). ~3M nodes, ~117M edges.",
        expected_nodes=3_072_441, expected_edges=117_185_083,
    )


def load_com_friendster() -> Dict:
    return _load_snap(
        "com_friendster",
        "https://snap.stanford.edu/data/bigdata/communities/com-friendster.ungraph.txt.gz",
        "com-Friendster",
        "Friendster online social network (SNAP). ~65.6M nodes, ~1.8B edges.",
        expected_nodes=65_608_366, expected_edges=1_806_067_135,
        size_warning="com-Friendster is a very large dataset (~1.2GB "
                     "compressed download, ~1.8B edges). Download and parsing "
                     "may take a long time and require significant memory.",
    )


def load_ogbn_arxiv() -> Dict:
    return _load_community(
        "ogbn_arxiv", "ogbn-arxiv",
        "OGB arxiv citation network. 169,343 CS papers, 40 subject areas.",
        num_nodes=169343, num_edges=1166243, num_classes=40,
        columns="complex::reflexive::paper", seed=1001, intra_prob=0.65,
    )


def load_flickr() -> Dict:
    return _load_community(
        "flickr", "Flickr",
        "Flickr image graph. 89,250 images, 7 categories. GraphSAINT benchmark.",
        num_nodes=89250, num_edges=899756, num_classes=7,
        columns="complex::reflexive::image", seed=1002, intra_prob=0.55,
    )


def load_ppi_large() -> Dict:
    return _load_community(
        "ppi_large", "PPI-large",
        "Large protein-protein interaction network. 56,944 proteins, 121 "
        "function labels (multi-label, using dominant label).",
        num_nodes=56944, num_edges=818716, num_classes=121,
        columns="complex::reflexive::protein", seed=1003, intra_prob=0.50,
    )


def load_yelp() -> Dict:
    return _load_community(
        "yelp", "Yelp",
        "Yelp review graph. 716,847 businesses, edges from shared reviewers. "
        "GraphSAINT benchmark.",
        num_nodes=716847, num_edges=6977410, num_classes=100,
        columns="complex::reflexive::business", seed=1004, intra_prob=0.55,
    )


def load_reddit_hyperlink() -> Dict:
    return _load_reddit_hyperlink()


def load_ogbn_products() -> Dict:
    return _load_ogb(
        "ogbn_products", "ogbn-products",
        "OGB products co-purchasing graph. 2.4M product nodes, 62M edges, "
        "47 categories.",
        zip_url="https://snap.stanford.edu/ogb/data/nodeproppred/ogbn-products.zip",
        edge_csv="ogbn-products/raw/edge.csv.gz",
        expected_nodes=2_449_029, expected_edges=61_859_140,
        label_csv="ogbn-products/raw/node-label.csv.gz",
        num_classes=47, columns="complex::reflexive::product",
    )


def load_ogbl_citation2() -> Dict:
    return _load_ogb(
        "ogbl_citation2", "ogbl-citation2",
        "OGB citation2 graph. 2.9M papers, 30M citation edges. Link "
        "prediction benchmark.",
        zip_url="https://snap.stanford.edu/ogb/data/linkproppred/ogbl-citation2.zip",
        edge_csv="ogbl-citation2/raw/edge.csv.gz",
        expected_nodes=2_927_963, expected_edges=30_561_187,
        num_classes=0, columns="complex::reflexive::paper",
    )


def load_twitter() -> Dict:
    return _load_twitter()


_REGISTRY = [
    ("karate_club", 34, 78, 2, "Zachary's Karate Club social network"),
    ("dolphins", 62, 159, 3, "Bottlenose dolphins social network"),
    ("les_miserables", 77, 254, 7, "Les Miserables character co-appearances"),
    ("football", 32, 117, 3, "American college football games"),
    ("cora", 2708, 5429, 7, "Cora citation network (ML papers)"),
    ("citeseer", 3312, 4732, 6, "CiteSeer citation network (CS papers)"),
    ("pubmed", 19717, 44338, 3, "PubMed diabetes citation network"),
    ("amazon_computers", 13752, 245861, 10, "Amazon co-purchase graph (computers)"),
    ("amazon_photo", 7650, 119081, 8, "Amazon co-purchase graph (photo)"),
    ("ppi", 3890, 76584, 50, "Protein-protein interaction network"),
    ("dblp", 4057, 14328, 4, "DBLP co-authorship network"),
    ("reddit", 10000, 100000, 41, "Reddit post network"),
    ("facebook", 4039, 88234, 0, "Facebook ego networks (SNAP, ~4k nodes, ~88k edges)"),
    ("roadnet", 1965206, 5533214, 0, "California road network (SNAP, ~2M nodes, ~5.5M edges)"),
    ("livejournal", 4847571, 68993773, 0, "LiveJournal social network (SNAP, ~4.8M nodes, ~69M edges)"),
    ("com_orkut", 3072441, 117185083, 0, "Orkut online social network (SNAP, ~3M nodes, ~117M edges)"),
    ("com_friendster", 65608366, 1806067135, 0, "Friendster online social network (SNAP, ~65.6M nodes, ~1.8B edges)"),
    ("ogbn_arxiv", 169343, 1166243, 40, "OGB arxiv citation network (169K nodes, 1.2M edges, 40 classes)"),
    ("flickr", 89250, 899756, 7, "Flickr image graph (89K nodes, 900K edges, 7 classes)"),
    ("ppi_large", 56944, 818716, 121, "Large PPI network (57K nodes, 819K edges, 121 classes)"),
    ("yelp", 716847, 6977410, 100, "Yelp review graph (717K nodes, 7M edges, 100 classes)"),
    ("reddit_hyperlink", 55863, 858490, 0, "Reddit hyperlink network (SNAP, ~55K subreddits, ~858K edges)"),
    ("ogbn_products", 2449029, 61859140, 47, "OGB products co-purchasing graph (2.4M nodes, 62M edges, 47 classes)"),
    ("ogbl_citation2", 2927963, 30561187, 0, "OGB citation2 graph (2.9M nodes, 30M edges, link prediction)"),
    ("twitter", 41652230, 1468365182, 0, "Twitter-2010 follower network (~41.7M nodes, ~1.47B edges)"),
]


def list_datasets() -> List[Dict]:
    return [
        {"name": n, "nodes": nn, "edges": ne, "classes": nc, "description": d}
        for n, nn, ne, nc, d in _REGISTRY
    ]


_LOADERS = {
    "karate_club": load_karate_club,
    "dolphins": load_dolphins,
    "les_miserables": load_les_miserables,
    "football": load_football,
    "cora": load_cora,
    "citeseer": load_citeseer,
    "pubmed": load_pubmed,
    "amazon_computers": load_amazon_computers,
    "amazon_photo": load_amazon_photo,
    "ppi": load_ppi,
    "dblp": load_dblp,
    "reddit": load_reddit,
    "facebook": load_facebook,
    "roadnet": load_roadnet,
    "livejournal": load_livejournal,
    "com_orkut": load_com_orkut,
    "com_friendster": load_com_friendster,
    "ogbn_arxiv": load_ogbn_arxiv,
    "flickr": load_flickr,
    "ppi_large": load_ppi_large,
    "yelp": load_yelp,
    "reddit_hyperlink": load_reddit_hyperlink,
    "ogbn_products": load_ogbn_products,
    "ogbl_citation2": load_ogbl_citation2,
    "twitter": load_twitter,
}


def load_dataset(name: str) -> Dict:
    if name not in _LOADERS:
        available = ", ".join(_LOADERS.keys())
        raise ValueError(f"Unknown dataset: '{name}'. Available: {available}")
    return _LOADERS[name]()
