"""The GCN of BASELINE config 3 on the CPU, in both packages, on one
embedding.

    JAX_PLATFORMS=cpu python scripts/gcn_config3_cpu.py

Generates config 3 (``datasets.load_dataset("ogbn_arxiv")``: 169,343
nodes, 1,166,243 edges, 40 classes, seed 1001) into a temporary cache,
embeds it with the JAX package's ``embed()`` (D=256, 40 iterations, the
reference defaults otherwise), then trains the GCN of each package at the
reference defaults (200 epochs) on that one embedding:
``cleora_tpu.classify.gcn_classify`` and
``cleora_tpu_torch.classify.gcn_classify(device="cpu")`` (the plain
versions of the port's kernels).  Prints each one's accuracy, macro-F1 and
seconds.  About 25 minutes on 8 cores.  The two packages draw their
dropout masks from different generators, so their scores agree only as
far as the masks' effect does.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import cleora_tpu as ct
    import cleora_tpu.classify as jcl
    import cleora_tpu.datasets as datasets
    import cleora_tpu_torch as ctt
    import cleora_tpu_torch.classify as tcl

    with tempfile.TemporaryDirectory() as cache:
        datasets._CACHE_DIR = datasets._COMPAT_CACHE_DIR = cache
        d = datasets.load_dataset("ogbn_arxiv")
    t0 = time.perf_counter()
    g = ct.SparseMatrix.from_iterator(iter(d["edges"]), d["columns"])
    emb = ct.embed(g, feature_dim=256, num_iterations=40)
    print(f"JAX package embed() of config 3: {emb.shape} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got = jcl.gcn_classify(g, emb, d["labels"])
    print(f"cleora_tpu.classify.gcn_classify: accuracy "
          f"{got['accuracy']:.4f}, macro-F1 {got['macro_f1']:.4f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    tg = ctt.SparseMatrix.from_iterator(iter(d["edges"]), d["columns"])
    assert list(tg.entity_ids) == list(g.entity_ids)
    got = tcl.gcn_classify(tg, emb, d["labels"], device="cpu")
    print(f"cleora_tpu_torch.classify.gcn_classify(device='cpu'): accuracy "
          f"{got['accuracy']:.4f}, macro-F1 {got['macro_f1']:.4f} "
          f"({time.perf_counter() - t0:.1f} s with ingest)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
