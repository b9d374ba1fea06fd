"""K17's sharded walk and K14 against the parent tree's on the same card, in
one process.

    python scripts/torch_k14_k17_probe.py --parent DIR

Needs a CUDA card.  ``DIR`` holds the parent tree's ``cleora_tpu_torch``
package (e.g. ``git archive <parent> cleora_tpu_torch | tar -x -C DIR``).
It is imported under another name, so its kernels build from its own
sources into its own build directory.  In the order parent, this tree,
this tree, parent (10 calls each, by CUDA events), it times:

* the first-order walk over row-sharded tables
  (``ops.walk.walk_uniform_sharded``: the parent's K17, one launch a slice
  a hop, against this tree's, one launch a slice a round) over one slice
  and over four slices in this process, on ``chip_smoke.py``'s phase 7
  batch (131,072 walks of 80 on the 1 M-node DeepWalk corpus), with this
  tree's rounds, beside K8 (its hop is now device code shared with K17) of
  both trees on the same walks;
* K14 (``ops.label_prop.label_prop_step``) on phase 5's 1,958,363-row graph
  (S = D⁻¹A) at C = 40 and C = 47, and this tree's at C = 47 in both
  layouts: its 47 columns (one column a group) and the stride of 48 that
  ``classify.LABEL_STRIDE`` gives label propagation (float4 groups);
* K1 with l2 fused (``ops.spmm.spmm``) at phase 5's shape, D = 256, of
  both trees (K1 shares ``row_team.cuh``'s gather with K14).

Every output is checked bitwise the parent's (the walks also K8's; K14's
48-column output in its first 47 columns).  Prints one JSON line a
measurement, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PARENT = "cleora_tpu_torch_parent"
TURNS = (["parent"], ["this"], ["this"], ["parent"])
WALKS = 131_072
K14_WIDTHS = (40, 47)
D = 256


def load_parent(parent_dir: str):
    """The parent tree's package, imported as :data:`PARENT`."""
    init = os.path.join(parent_dir, "cleora_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        PARENT, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def in_turns(runs: dict, turns=TURNS) -> dict:
    """Each of ``runs`` timed in the order of ``turns``: a name ``k`` of a
    turn times every run whose name starts with ``k``."""
    import chip_smoke as cs

    ms = {k: [] for k in runs}
    for names in turns:
        for prefix in names:
            for k in runs:
                if k.startswith(prefix):
                    ms[k].append(cs.time_ms(runs[k]))
    return ms


def k8_of(mod, t, starts, length: int):
    """K8 of a tree's ``ops.walk`` at seed 0 and base 0: over the tables
    where its ``walk_uniform`` takes them, else over their three arrays."""
    import inspect

    if "t" in inspect.signature(mod.walk_uniform).parameters:
        return mod.walk_uniform(t, starts, length, 0, 0)
    return mod.walk_uniform(t.indptr, t.cols, t.deg, starts, length, 0, 0,
                            t.n)


def k17_probe(card: str) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops import walk

    pwalk = importlib.import_module(PARENT + ".ops.walk")
    dev = torch.device("cuda")
    g = cs.random_graph(cs.WALK_NODES, cs.WALK_UND_EDGES, seed=7)
    indptr, cols, deg, n = alg._walk_csr(g)
    del g
    starts = torch.from_numpy(np.nonzero(deg > 0)[0][:WALKS]
                              .astype(np.int32)).to(dev)
    length = cs.WALK_LENGTH
    t8 = walk.WalkTables(indptr, cols, deg, n, dev)
    k8 = walk.walk_uniform(t8, starts, length, 0, 0)
    runs = {"parent K8": lambda: k8_of(pwalk, t8, starts, length),
            "this K8": lambda: walk.walk_uniform(t8, starts, length, 0, 0)}
    assert torch.equal(runs["parent K8"](), k8)
    slices = {}
    for world in (1, 4):
        mine = [walk.ShardedWalkTables(indptr, cols, deg, n, r, world, dev)
                for r in range(world)]
        theirs = [pwalk.ShardedWalkTables(indptr, cols, deg, n, r, world,
                                          dev) for r in range(world)]
        slices[world] = (mine, theirs)
        stats = {}
        runs[f"parent K17 x{world}"] = (
            lambda t=theirs: pwalk.walk_uniform_sharded(t, starts, length, 0,
                                                        0))
        runs[f"this K17 x{world}"] = (
            lambda t=mine: walk.walk_uniform_sharded(t, starts, length, 0, 0,
                                                     stats=stats))
        assert torch.equal(runs[f"parent K17 x{world}"](), k8)
        before = kernels.LAUNCHES["walk_owned"]
        assert torch.equal(runs[f"this K17 x{world}"](), k8)
        print(json.dumps({"probe": "K17 rounds", "slices": world,
                          "rounds": stats["rounds"],
                          "launches": kernels.LAUNCHES["walk_owned"] - before,
                          "card": card}), flush=True)
    print(json.dumps({"probe": "K17", "walks": WALKS, "length": length,
                      "bound_ms": cs.k17_sector_bytes(k8, n)
                      / cs.HBM_BYTES_PER_S * 1e3,
                      "ms": in_turns(runs), "card": card}), flush=True)
    del slices, runs, t8, k8
    torch.cuda.empty_cache()


def k14_k1_probe(card: str) -> None:
    import torch.nn.functional as F

    import chip_smoke as cs
    import cleora_tpu_torch.classify as cl
    from cleora_tpu_torch.ops.label_prop import label_prop_step
    from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm

    plp = importlib.import_module(PARENT + ".ops.label_prop")
    pspmm = importlib.import_module(PARENT + ".ops.spmm")
    dev = torch.device("cuda")
    big = cs.random_graph(cs.FULL_NODES, cs.FULL_UND_EDGES, seed=7)
    rows, cols, svals, n = cl._row_normalized(big)
    del big
    S = CsrMatrix.from_coo(rows, cols, svals, n, dev)
    pS = pspmm.CsrMatrix.from_coo(rows, cols, svals, n, dev)
    del rows, cols, svals
    for c in K14_WIDTHS:
        f, y, mask = cs.label_state(n, c, dev, c)
        out = {k: torch.empty_like(f) for k in ("parent", "this")}
        runs = {"parent": lambda: plp.label_prop_step(
                    pS, f, y, mask, 0.5, 0.5, out=out["parent"]),
                "this": lambda: label_prop_step(S, f, y, mask, 0.5, 0.5,
                                                out=out["this"])}
        wide = -(-c // cl.LABEL_STRIDE) * cl.LABEL_STRIDE
        if wide != c:
            fw, yw = F.pad(f, (0, wide - c)), F.pad(y, (0, wide - c))
            ow = torch.empty_like(fw)
            runs[f"this at a stride of {wide}"] = (
                lambda: label_prop_step(S, fw, yw, mask, 0.5, 0.5, out=ow))
        for fn in runs.values():
            fn()
        assert torch.equal(out["this"], out["parent"]), c
        assert torch.equal(out["this"][mask], y[mask]), c
        if wide != c:
            assert torch.equal(ow[:, :c], out["parent"]), c
        nbytes = 8 * (n + 1) + 8 * S.nnz + 3 * 4 * n * c + n
        print(json.dumps({"probe": "K14", "rows": n, "nnz": S.nnz, "c": c,
                          "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                          "ms": in_turns(runs), "card": card}), flush=True)
        del f, y, mask, out, runs
        if wide != c:
            del fw, yw, ow
    gen = torch.Generator(device=dev).manual_seed(D)
    x = torch.randn((n, D), device=dev, generator=gen)
    runs = {"parent": lambda: pspmm.spmm(pS, x, normalization="l2"),
            "this": lambda: spmm(S, x, normalization="l2")}
    assert torch.equal(runs["parent"](), runs["this"]())
    print(json.dumps({"probe": "K1 l2 fused", "rows": n, "nnz": S.nnz,
                      "d": D, "ms": in_turns(runs), "card": card}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from cleora_tpu_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    build.build()
    load_parent(args.parent)
    k17_probe(card)
    k14_k1_probe(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
