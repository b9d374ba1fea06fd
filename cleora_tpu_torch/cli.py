"""Command-line interface of the port, ``python -m cleora_tpu_torch`` or
``cleora-tpu-torch``: ``embed|info|benchmark|similar|merge-shards`` with the
flags and output of the JAX package's CLI (cleora_tpu/cli.py, itself after
the reference's pycleora/cli.py).

The commands that compute run on the card unless ``--device cpu`` is
given (the JAX CLI's ``--cpu``).  ``plan`` and ``scaling`` are not ported
yet and exit with a message that says so.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


_NOT_PORTED = {
    "scaling": "the scaling report is not ported yet: it measures the "
               "multi-GPU slice of the port (ROADMAP.md, queue A item 8)",
    "plan": "the capacity plan is not ported yet (ROADMAP.md, queue A "
            "item 7)",
}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="cleora-tpu-torch",
        description="cleora_tpu_torch - Graph Embedding CLI (PyTorch/CUDA)",
    )
    sub = parser.add_subparsers(dest="command")

    def device_flag(p):
        p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                       help="Where to compute (default: the CUDA card; "
                            "'cpu' runs the kernels' plain versions)")

    p = sub.add_parser("embed", help="Generate graph embeddings")
    p.add_argument("--input", "-i", required=True,
                   help="Input edge file (TSV/CSV/space-separated)")
    p.add_argument("--output", "-o", default=None,
                   help="Output file (npz/csv/tsv); required except with "
                        "--shard (which builds a graph piece, no "
                        "embeddings)")
    p.add_argument("--dim", "-d", type=int, default=256,
                   help="Embedding dimension (default: 256)")
    p.add_argument("--iterations", "-n", type=int, default=40,
                   help="Number of iterations (default: 40)")
    p.add_argument("--propagation", "-p", choices=["left", "symmetric"],
                   default="left")
    p.add_argument("--normalization", choices=["l2", "l1", "none"], default="l2")
    p.add_argument("--columns", "-c", default="complex::reflexive::node",
                   help="Column definition")
    p.add_argument("--algorithm", "-a", default="cleora",
                   choices=["cleora", "prone", "randne", "hope", "netmf",
                            "grarep", "deepwalk", "node2vec"])
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="Embedding storage dtype (bfloat16 halves HBM)")
    p.add_argument("--backend", choices=["host", "device"], default="host",
                   help="Sibling-algorithm compute backend: 'device' runs "
                        "prone/randne/hope/netmf/grarep/deepwalk/node2vec "
                        "on --device (cleora itself always runs there)")
    p.add_argument("--factorization", choices=["host", "device", "sharded"],
                   default=None,
                   help="deepwalk/node2vec PPMI factorization: 'device' "
                        "runs a randomized SVD on the device instead of "
                        "host ARPACK (requires --backend device; implied by "
                        "--cooccurrence device); 'sharded' is not ported "
                        "yet")
    p.add_argument("--cooccurrence", choices=["host", "device"],
                   default="host",
                   help="deepwalk/node2vec pair counting: 'device' keeps "
                        "the whole walk pipeline on the device — the right "
                        "mode on weak hosts (requires --backend device; "
                        "implies the device factorization)")
    p.add_argument("--walk-tables",
                   choices=["auto", "replicated", "sharded"],
                   default="auto",
                   help="deepwalk/node2vec walk-CSR placement: 'sharded' "
                        "is not ported yet; 'auto' fit-checks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--streaming", metavar="DIR", default=None,
                   help="Out-of-core build: spill the graph to DIR "
                        "(bounded RAM; for inputs too big to build "
                        "in-memory; cleora algorithm only; unlike the "
                        "in-memory path, # comment lines are not stripped)")
    p.add_argument("--shard", metavar="K/P", default=None,
                   help="With --streaming: build only row shard K of P "
                        "(multi-host sharded ingest — every host scans the "
                        "input, each sorts/merges 1/P of it) and exit; "
                        "combine pieces with the merge-shards command")
    p.add_argument("--entities", type=int, default=None,
                   help="With --shard: the global entity count (e.g. from "
                        "host 0's pass), skipping the index-only first scan")
    p.add_argument("--sharded", nargs="?", const=0, type=int, default=None,
                   metavar="N",
                   help="cleora: the sharded loop over N ranks (omit N "
                        "to use every rank of the process group; launch "
                        "N > 1 with torchrun --nproc-per-node N, one card "
                        "per rank).  With a .npy --output the embedding "
                        "streams shard by shard into the file — no process "
                        "holds the full (N, D) matrix.  Sibling algorithms: "
                        "not ported yet")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="cleora + --sharded: persist the sharded loop "
                        "state to DIR every --checkpoint-every iterations. "
                        "deepwalk/node2vec + --cooccurrence device: "
                        "persist each finished counting pass (every K-th) "
                        "— a killed run resumes byte-identically.  Either "
                        "way an interrupted run resumes from the last "
                        "complete checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=None, metavar="K",
                   help="Checkpoint cadence — iterations (cleora, default "
                        "10) or counting passes (walk pipeline, default 1)")
    device_flag(p)
    p.add_argument("--verbose", "-v", action="store_true")

    p = sub.add_parser(
        "merge-shards",
        help="Concatenate sharded streaming-build pieces into one graph dir",
    )
    p.add_argument("pieces", nargs="+", help="Piece directories (any order)")
    p.add_argument("--output", "-o", required=True, help="Merged graph dir")
    p.add_argument("--verbose", "-v", action="store_true")

    for name in _NOT_PORTED:  # they exit saying so, whatever follows
        sub.add_parser(name, help="Not ported yet")

    p = sub.add_parser("info", help="Show graph information")
    p.add_argument("--input", "-i", required=True, help="Input edge file")
    p.add_argument("--columns", "-c", default="complex::reflexive::node")

    p = sub.add_parser("benchmark", help="Run benchmarks")
    p.add_argument("--dataset", "-d", default="karate_club", help="Dataset name")
    p.add_argument("--dim", type=int, default=256)
    device_flag(p)

    p = sub.add_parser("similar", help="Find similar entities")
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--columns", "-c", default="complex::reflexive::node")
    p.add_argument("--entity", "-e", required=True, help="Query entity")
    p.add_argument("--top-k", "-k", type=int, default=10)
    p.add_argument("--dim", "-d", type=int, default=256)
    device_flag(p)

    args, extra = parser.parse_known_args(argv)
    if args.command in _NOT_PORTED:
        raise SystemExit(_NOT_PORTED[args.command])
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.command is None:
        parser.print_help()
        return
    rc = {"embed": _cmd_embed, "info": _cmd_info,
          "benchmark": _cmd_benchmark, "similar": _cmd_similar,
          "merge-shards": _cmd_merge_shards}[args.command](args)
    if rc:
        raise SystemExit(rc)


def _read_edges(filepath):
    """Strip blank lines and # comments (reference cli.py:58-66)."""
    edges = []
    with open(filepath, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                edges.append(line)
    return edges


def _cmd_embed(args):
    from .sparse import SparseMatrix

    import os

    if args.shard is not None and args.streaming is None:
        raise SystemExit("--shard requires --streaming DIR")
    if args.output is None and args.shard is None:
        raise SystemExit("--output is required (omit it only with --shard)")

    if (args.streaming is None and os.path.isdir(args.input)
            and os.path.exists(os.path.join(args.input, "meta.json"))):
        # a finished streaming-build directory (e.g. merge-shards output):
        # embed straight off the on-disk CSR
        if args.algorithm != "cleora":
            raise SystemExit(
                "graph-directory input supports only --algorithm cleora"
            )
        from .graph.stream import DiskGraph

        _finish_embed(args, DiskGraph(args.input))
        return

    if args.streaming is not None:
        # out-of-core: file streams through the spill/merge builder and the
        # embed reads the resulting on-disk CSR one row block at a time
        if args.algorithm != "cleora":
            raise SystemExit(
                "--streaming supports only --algorithm cleora"
            )
        if args.shard is not None:
            from .graph.stream import build_graph_streaming_sharded

            try:
                k, p = (int(x) for x in args.shard.split("/"))
            except ValueError:
                raise SystemExit("--shard must look like K/P, e.g. 0/4")
            t0 = time.time()
            piece = build_graph_streaming_sharded(
                [args.input], args.columns, args.streaming, k, p, files=True,
                n_entities=args.entities,
            )
            lo, hi = piece.meta["row_range"]
            print(f"Built shard {k}/{p} (rows [{lo}, {hi}) of "
                  f"{piece.num_entities}; {piece.num_edges} edges, "
                  f"{time.time() - t0:.2f}s) -> {args.streaming}")
            return
        from .graph.stream import build_graph_streaming

        if args.verbose:
            print(f"Streaming build of {args.input} -> {args.streaming} ...")
        t0 = time.time()
        graph = build_graph_streaming(
            [args.input], args.columns, args.streaming, files=True
        )
        if args.verbose:
            print(f"  {graph.num_entities} entities, {graph.num_edges} "
                  f"edges ({time.time() - t0:.2f}s)")
        _finish_embed(args, graph)
        return

    if args.verbose:
        print(f"Reading edges from {args.input}...")
    edges = _read_edges(args.input)
    if args.verbose:
        print(f"  {len(edges)} edges loaded")
        print(f"Building graph (columns={args.columns})...")

    t0 = time.time()
    graph = SparseMatrix.from_iterator(iter(edges), args.columns)
    if args.verbose:
        print(f"  {graph.num_entities} entities, {graph.num_edges} edges "
              f"({time.time() - t0:.2f}s)")

    _finish_embed(args, graph)


def _finish_embed(args, graph):
    from . import embed
    from .algorithms import (embed_deepwalk, embed_grarep, embed_hope,
                             embed_netmf, embed_node2vec, embed_prone,
                             embed_randne)
    from .io_utils import save_embeddings

    if args.verbose:
        print(f"Generating {args.dim}-dim embeddings using {args.algorithm}...")

    t0 = time.time()
    be = getattr(args, "backend", "host")
    if be == "device" and args.algorithm == "cleora":
        raise SystemExit(
            "--backend device is not applicable to --algorithm cleora "
            "(cleora always runs on device)"
        )
    walk_algo = args.algorithm in ("deepwalk", "node2vec")
    walk_lifecycle = (walk_algo
                      and getattr(args, "cooccurrence", "host") == "device")
    if getattr(args, "checkpoint_dir", None):
        if walk_algo and not walk_lifecycle:
            raise SystemExit(
                "--checkpoint-dir with deepwalk/node2vec requires "
                "--cooccurrence device (the counting checkpoint is "
                "per device counting pass)"
            )
        if not walk_algo and args.sharded is None:
            raise SystemExit("--checkpoint-dir requires --sharded")
        if not walk_algo and args.algorithm != "cleora":
            raise SystemExit(
                "--checkpoint-dir supports --algorithm cleora and the "
                "device walk pipeline (deepwalk/node2vec + "
                "--cooccurrence device)"
            )
    dev = args.device
    if getattr(args, "sharded", None) is not None and args.algorithm != "cleora":
        from .algorithms import _SHARDED_NOT_PORTED

        raise SystemExit(_SHARDED_NOT_PORTED)
    disk_npy = (args.algorithm == "cleora" and not hasattr(graph, "data")
                and args.output.endswith(".npy"))
    if getattr(args, "sharded", None) is not None or disk_npy:
        # scale lifecycle: the sharded loop with optional checkpointing and
        # memory-bounded direct-to-.npy output (parallel/embed.py); a
        # streamed build runs there anyway, so its .npy output streams too;
        # under torchrun every rank joins the process group first
        from .parallel import init_distributed
        from .parallel.embed import embed_sharded

        init_distributed(device=dev)
        to_npy = args.output.endswith(".npy")
        emb = embed_sharded(
            graph, feature_dim=args.dim, num_iterations=args.iterations,
            propagation=args.propagation, normalization=args.normalization,
            seed=args.seed, dtype=args.dtype,
            n_devices=args.sharded or None,
            out=args.output if to_npy else "full",
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=(10 if args.checkpoint_every is None
                              else args.checkpoint_every),
            device=dev,
        )
        dt = time.time() - t0
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_rank() != 0:
            return  # rank 0 reports and saves the full result
        if to_npy:
            print(f"{graph.num_entities} entities -> {emb.shape} streamed "
                  f"to {args.output} ({dt:.2f}s)")
            return
        from .io_utils import save_embeddings as _save

        fmt = ("csv" if args.output.endswith(".csv")
               else "tsv" if args.output.endswith(".tsv") else "npz")
        _save(graph, emb, args.output, format=fmt)
        print(f"{graph.num_entities} entities -> {emb.shape} saved to "
              f"{args.output} ({dt:.2f}s)")
        return
    fact = getattr(args, "factorization", None)
    cooc = getattr(args, "cooccurrence", "host")
    wtab = getattr(args, "walk_tables", "auto")
    if wtab != "auto" and args.algorithm not in ("deepwalk", "node2vec"):
        raise SystemExit(
            "--walk-tables applies only to --algorithm deepwalk/node2vec"
        )
    if fact is not None or cooc != "host":
        if args.algorithm not in ("deepwalk", "node2vec"):
            raise SystemExit(
                "--factorization/--cooccurrence apply only to "
                "--algorithm deepwalk/node2vec"
            )
        if be != "device":
            raise SystemExit(
                "--factorization/--cooccurrence device require "
                "--backend device"
            )
        if fact == "host" and cooc == "device":
            raise SystemExit(
                "--cooccurrence device runs the factorization on device; "
                "drop --factorization host"
            )
    algo_map = {
        "cleora": lambda: embed(graph, args.dim, args.iterations,
                                args.propagation, args.normalization, args.seed,
                                dtype=args.dtype, device=dev),
        "prone": lambda: embed_prone(graph, args.dim, seed=args.seed,
                                     backend=be, device=dev),
        "randne": lambda: embed_randne(graph, args.dim, seed=args.seed,
                                       backend=be, device=dev),
        "hope": lambda: embed_hope(graph, args.dim, backend=be, device=dev),
        "netmf": lambda: embed_netmf(graph, args.dim, seed=args.seed,
                                     backend=be, device=dev),
        "grarep": lambda: embed_grarep(graph, args.dim, seed=args.seed,
                                       backend=be, device=dev),
        "deepwalk": lambda: embed_deepwalk(graph, args.dim, seed=args.seed,
                                           backend=be, factorization=fact,
                                           cooccurrence=cooc,
                                           walk_tables=wtab, device=dev,
                                           **walk_kw),
        "node2vec": lambda: embed_node2vec(graph, args.dim, seed=args.seed,
                                           backend=be, factorization=fact,
                                           cooccurrence=cooc,
                                           walk_tables=wtab, device=dev,
                                           **walk_kw),
    }
    walk_kw = {}
    if walk_lifecycle:
        walk_kw = {
            "checkpoint_dir": getattr(args, "checkpoint_dir", None),
            "checkpoint_every": (1 if args.checkpoint_every is None
                                 else args.checkpoint_every),
        }
        if args.output.endswith(".npy"):
            # stream the final embedding straight into the .npy (bounded
            # chunked fetches, no (n, d) host materialization)
            walk_kw["out"] = args.output
    emb = algo_map[args.algorithm]()
    if walk_kw.get("out"):
        print(f"{graph.num_entities} entities -> {emb.shape} streamed "
              f"to {args.output} ({time.time() - t0:.2f}s)")
        return

    if args.verbose:
        print(f"  Shape: {emb.shape} ({time.time() - t0:.2f}s)")
        print(f"Saving to {args.output}...")

    fmt = "npz"
    if args.output.endswith(".csv"):
        fmt = "csv"
    elif args.output.endswith(".tsv"):
        fmt = "tsv"
    save_embeddings(graph, emb, args.output, format=fmt)

    if args.verbose:
        print("Done!")
    else:
        print(f"{graph.num_entities} entities -> {emb.shape} saved to "
              f"{args.output}")


def _cmd_merge_shards(args):
    from .graph.stream import merge_disk_graph_shards

    t0 = time.time()
    merged = merge_disk_graph_shards(args.pieces, args.output)
    print(f"Merged {len(args.pieces)} piece(s) -> {args.output} "
          f"({merged.num_entities} entities, {merged.num_edges} edges, "
          f"{time.time() - t0:.2f}s)")


def _cmd_info(args):
    from .sparse import SparseMatrix

    graph = SparseMatrix.from_iterator(iter(_read_edges(args.input)),
                                       args.columns)
    print(f"Graph: {graph.num_entities} entities, {graph.num_edges} edges")
    print(f"Columns: {args.columns}")
    degrees = graph.entity_degrees
    print(f"Degree stats: min={degrees.min():.0f}, max={degrees.max():.0f}, "
          f"mean={degrees.mean():.1f}, median={np.median(degrees):.1f}")


def _cmd_benchmark(args):
    from . import embed
    from .algorithms import (embed_deepwalk, embed_node2vec, embed_prone,
                             embed_randne)
    from .benchmark import benchmark_algorithms, format_benchmark_table
    from .datasets import load_dataset
    from .sparse import SparseMatrix

    ds = load_dataset(args.dataset)
    graph = SparseMatrix.from_iterator(iter(ds["edges"]), ds["columns"])
    algorithms = {
        "cleora": lambda g: embed(g, args.dim, 40, device=args.device),
        "prone": lambda g: embed_prone(g, args.dim),
        "randne": lambda g: embed_randne(g, args.dim),
        "deepwalk": lambda g: embed_deepwalk(g, args.dim),
        "node2vec": lambda g: embed_node2vec(g, args.dim),
    }
    print(f"Benchmarking on {ds['name']} ({ds['num_nodes']} nodes)...")
    results = benchmark_algorithms(graph, ds["labels"], algorithms)
    print(format_benchmark_table(results))


def _cmd_similar(args):
    from . import embed, find_most_similar
    from .sparse import SparseMatrix

    graph = SparseMatrix.from_iterator(iter(_read_edges(args.input)),
                                       args.columns)
    emb = embed(graph, args.dim, device=args.device)
    for r in find_most_similar(graph, emb, args.entity, top_k=args.top_k):
        print(f"  {r['entity_id']:<30s} similarity={r['similarity']:.4f}")


if __name__ == "__main__":
    main()
