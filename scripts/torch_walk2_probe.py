"""K18's path and K15 against the parent tree's on the same card, in one
process.

    python scripts/torch_walk2_probe.py --parent DIR [--chunks 4,8,16]

Needs a CUDA card.  ``DIR`` holds the parent tree's ``cleora_tpu_torch``
package (e.g. ``git archive <parent> cleora_tpu_torch | tar -x -C DIR``).
It is imported under another name, so its kernels build from its own
sources into its own build directory.  In the order parent, this tree,
this tree, parent (10 calls each, by CUDA events), it times:

* the sharded second-order walk (``ops.walk.walk_p_q_sharded``: the
  parent's five-stage K18, this tree's local stage and chunked cross-owner
  rounds) over one slice and over four slices summed in this process, on
  ``chip_smoke.py``'s phase 8 batch (131,072 walks of 10, p = 0.5, q = 2,
  on the 1 M-node walk corpus), beside K12 on the same walks; with
  ``--chunks`` this tree's four-slice path also at those rounds a chunk
  (``ops.walk.WALK2_CHUNK``), with its launches a hop;
* K12 itself (its hop is now device code shared with K18) on the whole
  phase 8 batch (131,072 walks of 80);
* K15's forward and backward at (1,958,363, 64), p = 0.5, beside
  ``F.dropout(F.relu)`` and its autograd backward, and the device memory
  each tree's ``ReluDropout`` holds between its forward and its backward;
* the peak device memory of one GCN training step (``classify._gcn_sgd_``:
  2 layers, hidden width 64, dropout 0.5) of each tree on an
  ogbn-arxiv-shaped random graph (``chip_smoke.py``'s config 3 sizes) with
  256 random features a node.

The walks and K15's outputs of both trees are checked bitwise equal.
Prints one JSON line a measurement, and the card's name and power limit.
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
K15_ROWS, K15_WIDTH = 1_958_363, 64
K18_LENGTH = 10


def load_parent(parent_dir: str):
    """The parent tree's package, imported as :data:`PARENT`."""
    init = os.path.join(parent_dir, "cleora_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        PARENT, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def in_turns(runs: dict, pairs) -> dict:
    """Each of ``runs`` timed in the order of ``pairs`` (lists of names)."""
    import chip_smoke as cs

    ms = {k: [] for k in runs}
    for names in pairs:
        for k in names:
            ms[k].append(cs.time_ms(runs[k]))
    return ms


def walk_probe(parent, chunks, card: str) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops import walk

    pwalk = importlib.import_module(PARENT + ".ops.walk")
    dev = torch.device("cuda")
    g = cs.random_graph(cs.WALK_NODES, cs.WALK_UND_EDGES, seed=7)
    indptr, cols, deg, n, vals, wmax, wsum = alg._walk_csr(g, with_vals=True)
    del g
    starts = torch.from_numpy(np.nonzero(deg > 0)[0][:alg._WALK2_BATCH]
                              .astype(np.int32)).to(dev)
    args = (K18_LENGTH, float(np.float32(1.0 / cs.N2V_P)),
            float(np.float32(1.0 / cs.N2V_Q)), walk.walk2_tries(cs.N2V_Q),
            0, 0)
    t12 = walk.WalkTables2(indptr, cols, deg, n, vals, wmax, wsum, dev)
    k12 = walk.walk_p_q(t12, starts, *args[:4], 0, 0)
    pk12 = importlib.import_module(PARENT + ".kernels")
    whole = starts.shape[0], cs.WALK_LENGTH
    runs = {"parent": lambda: pk12.walk_p_q(
                t12.indptr, t12.cols, t12.vals, t12.deg, t12.wmax, t12.wsum,
                starts, whole[1], *args[1:4], 0, 0, n),
            "this": lambda: walk.walk_p_q(t12, starts, whole[1],
                                          *args[1:4], 0, 0)}
    assert torch.equal(runs["parent"](), runs["this"]())
    print(json.dumps({"probe": "K12", "walks": whole[0],
                      "length": whole[1],
                      "ms": in_turns(runs, (["parent"], ["this"], ["this"],
                                            ["parent"])),
                      "card": card}), flush=True)
    for world in (1, 4):
        mine = [walk.ShardedWalkTables(indptr, cols, deg, n, r, world, dev,
                                       vals, wmax, wsum)
                for r in range(world)]
        theirs = [pwalk.ShardedWalkTables(indptr, cols, deg, n, r, world, dev,
                                          vals, wmax, wsum)
                  for r in range(world)]
        runs = {"parent": lambda: pwalk.walk_p_q_sharded(theirs, starts,
                                                         *args),
                "this": lambda: walk.walk_p_q_sharded(mine, starts, *args)}
        assert torch.equal(runs["parent"](), k12)
        assert torch.equal(runs["this"](), k12)
        before = kernels.LAUNCHES["walk2_owned"]
        runs["this"]()
        hop = (kernels.LAUNCHES["walk2_owned"] - before) / (K18_LENGTH - 1)
        ms = in_turns(runs, (["parent"], ["this"], ["this"], ["parent"]))
        print(json.dumps({"probe": "K18", "slices": world,
                          "walks": starts.shape[0], "length": K18_LENGTH,
                          "chunk": walk.WALK2_CHUNK, "ms": ms,
                          "launches_a_hop": hop,
                          "k12_ms": cs.time_ms(lambda: walk.walk_p_q(
                              t12, starts, *args[:4], 0, 0)),
                          "card": card}), flush=True)
        if world == 4:
            default = walk.WALK2_CHUNK
            for chunk in chunks:
                walk.WALK2_CHUNK = chunk
                assert torch.equal(runs["this"](), k12)
                before = kernels.LAUNCHES["walk2_owned"]
                runs["this"]()
                hop = (kernels.LAUNCHES["walk2_owned"] - before) / (
                    K18_LENGTH - 1)
                print(json.dumps({"probe": "K18 chunk", "slices": world,
                                  "chunk": chunk,
                                  "ms": cs.time_ms(runs["this"]),
                                  "launches_a_hop": hop, "card": card}),
                      flush=True)
            walk.WALK2_CHUNK = default
        del mine, theirs, runs
    torch.cuda.empty_cache()


def held_for_backward(apply, z_of) -> int:
    """Bytes of device memory a ReLU-dropout layer holds from its forward
    to its backward, beyond its output: ``z`` made by a product so that
    only the autograd graph keeps it."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    h = apply(z_of())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before - h.numel() * 4
    del h
    return held


def k15_probe(parent, card: str) -> None:
    import torch.nn.functional as F

    import chip_smoke as cs
    from cleora_tpu_torch.ops import gcn

    pgcn = importlib.import_module(PARENT + ".ops.gcn")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    z = torch.randn((K15_ROWS, K15_WIDTH), device=dev, generator=gen)
    dh = torch.randn((K15_ROWS, K15_WIDTH), device=dev, generator=gen)
    args = (0.5, 42, 7, 0)
    h, mask = gcn.relu_dropout(z, *args)
    assert torch.equal(h, pgcn.relu_dropout(z, *args))
    assert torch.equal(gcn.relu_dropout_backward(mask, dh, 0.5),
                       pgcn.relu_dropout_backward(z, dh, *args))
    z_leaf = z.detach().requires_grad_()
    y_lib = F.dropout(F.relu(z_leaf), 0.5)
    runs = {"parent forward": lambda: pgcn.relu_dropout(z, *args),
            "this forward": lambda: gcn.relu_dropout(z, *args),
            "parent backward": lambda: pgcn.relu_dropout_backward(z, dh,
                                                                  *args),
            "this backward": lambda: gcn.relu_dropout_backward(mask, dh,
                                                               0.5),
            "F.dropout(F.relu)": lambda: F.dropout(F.relu(z), 0.5),
            "autograd backward of F.dropout(F.relu)": lambda:
                torch.autograd.grad(y_lib, z_leaf, dh, retain_graph=True)}
    ms = in_turns(runs, (
        ["parent forward", "parent backward"],
        ["this forward", "this backward"],
        ["this forward", "this backward"],
        ["parent forward", "parent backward",
         "F.dropout(F.relu)", "autograd backward of F.dropout(F.relu)"]))
    del y_lib, z_leaf, h, mask
    elems = K15_ROWS * K15_WIDTH
    new_bytes = 8 * elems + 4 * ((elems + 31) // 32)
    w = torch.eye(K15_WIDTH, device=dev)
    x = z.detach().requires_grad_()
    x @ w  # the library's workspace, allocated at its first product
    held = {name: held_for_backward(
        lambda t: fn.ReluDropout.apply(t, *args), lambda: x @ w)
        for name, fn in (("parent", pgcn), ("this", gcn))}
    print(json.dumps({"probe": "K15", "shape": [K15_ROWS, K15_WIDTH],
                      "p": 0.5, "ms": ms,
                      "bound_ms": {"8.125 B an element": new_bytes
                                   / cs.HBM_BYTES_PER_S * 1e3,
                                   "parent forward, 8 B": 8 * elems
                                   / cs.HBM_BYTES_PER_S * 1e3,
                                   "parent backward, 12 B": 12 * elems
                                   / cs.HBM_BYTES_PER_S * 1e3},
                      "held_for_backward_bytes": held, "card": card}),
          flush=True)


def gcn_probe(card: str) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.classify as cl

    pcl = importlib.import_module(PARENT + ".classify")
    dev = torch.device("cuda")
    g = cs.random_graph(cs.ARXIV_NODES, cs.ARXIV_EDGES, seed=3)
    n = g.num_entities
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, 256)).astype(
        np.float32)).to(dev)
    train = torch.arange(0, n, 2, device=dev)
    y = torch.from_numpy(rng.integers(0, cs.ARXIV_CLASSES, train.shape[0])
                         ).to(dev)
    weights = [rng.standard_normal((256, cs.GCN_HIDDEN)).astype(np.float32),
               rng.standard_normal((cs.GCN_HIDDEN, cs.ARXIV_CLASSES))
               .astype(np.float32)]
    peak = {}
    for name, mod in (("parent", pcl), ("this", cl), ("this", cl),
                      ("parent", pcl)):
        adj = mod._gcn_operators(g, dev)
        params = [cl._leaf(w, dev) for w in weights]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with cl.full_float32_matmul():
            mod._gcn_sgd_(params, x, adj, train, y, 0.01, 1e-4, 0.5, 42, 0)
        torch.cuda.synchronize()
        peak.setdefault(name, []).append(
            torch.cuda.max_memory_allocated() - before)
        del adj, params
    print(json.dumps({"probe": "GCN step peak", "nodes": n,
                      "hidden": cs.GCN_HIDDEN,
                      "peak_bytes_above_inputs": peak, "card": card}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--chunks", default="",
                    help="rounds a chunk to time the four-slice path at")
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
    parent = load_parent(args.parent)
    chunks = [int(c) for c in args.chunks.split(",") if c]
    k15_probe(parent, card)
    gcn_probe(card)
    walk_probe(parent, chunks, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
