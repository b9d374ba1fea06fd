"""How many rows of each dataset graph the hub slices would cut.

    python scripts/torch_hub_census.py [--names cora,ogbn_arxiv,...]

For each dataset of ``cleora_tpu_torch.datasets`` that is built without
a download (the bundled graphs and the synthetic loaders; the SNAP and OGB
loaders are never called), builds the graph as a user would
(``SparseMatrix.from_iterator`` over its edges and columns) and prints
one JSON line: its entities and CSR entries, its largest row, and the rows
of more than ``kernels.LONG_SLICE`` entries (the rows that K1, the fused
attention pass and K5 cut into slices) with the entries they hold.  The
generated data goes to a temporary directory.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# the loaders that build their graph locally
OFFLINE = ("karate_club", "dolphins", "les_miserables", "football", "cora",
           "citeseer", "pubmed", "amazon_computers", "amazon_photo", "ppi",
           "dblp", "reddit", "ogbn_arxiv", "flickr", "ppi_large", "yelp")


def census(name: str) -> dict:
    import cleora_tpu_torch as ctt
    from cleora_tpu_torch import datasets, kernels

    t0 = time.perf_counter()
    d = datasets.load_dataset(name)
    g = ctt.SparseMatrix.from_iterator(iter(d["edges"]), d["columns"])
    deg = np.diff(g.data.indptr)
    over = deg > kernels.LONG_SLICE
    return {"dataset": name, "entities": int(g.num_entities),
            "entries": int(deg.sum()), "largest_row": int(deg.max()),
            "rows_over_long_slice": int(over.sum()),
            "entries_in_them": int(deg[over].sum()),
            "long_slice": kernels.LONG_SLICE,
            "seconds": round(time.perf_counter() - t0, 3)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--names", default=",".join(OFFLINE))
    args = ap.parse_args()
    names = args.names.split(",")
    unknown = [n for n in names if n not in OFFLINE]
    if unknown:
        print(f"not built without a download: {unknown}", file=sys.stderr)
        return 2
    from cleora_tpu_torch import datasets

    with tempfile.TemporaryDirectory() as cache:
        datasets._CACHE_DIR = datasets._COMPAT_CACHE_DIR = cache
        for name in names:
            print(json.dumps(census(name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
