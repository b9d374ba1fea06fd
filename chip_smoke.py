#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (cleora_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. environment: the card's name and power limit, torch/CUDA versions;
2. build: K1 (kernels/spmm_csr.cu), K2 (kernels/row_normalize.cu), K3
   (kernels/hash_init.cu), K4 (kernels/edge_attention.cu), K5
   (kernels/spmm_axpy.cu), K6 (kernels/dense_markov.cu), K7
   (kernels/log_clip.cu), K8 (kernels/walk_uniform.cu), K9
   (kernels/pair_enum.cu), K10 (kernels/run_length.cu), K11
   (kernels/ppmi.cu), K12 (kernels/walk_p_q.cu), K13 (kernels/pq_adc.cu),
   K14 (kernels/label_prop.cu), K15 (kernels/relu_dropout.cu), K16
   (kernels/halo_pack.cu), K17 (kernels/walk_owned.cu), K18
   (kernels/walk2_owned.cu) and K19 (kernels/spmm_acc.cu) are compiled
   from the checkout's sources, one nvcc each, in parallel;
3. each kernel against its plain PyTorch version on the card: K1 on a random
   Markov CSR with zero-degree rows, a row whose values are all 0 and one
   row of degree 50,000 (cut into slices; at D=256 also walked by one
   warp), D in {8, 256, 300, 1028, 4096} (past 1,024 columns K1 loops over
   column tiles, as the blocked paths do, and K2 normalises after it),
   float32 and bfloat16 x, residual weight 0 and 0.3, normalisation none,
   l2 and l1 (float32 rtol=1e-5, atol=1e-6, the hub row against a float64
   reference at the same tolerance; bfloat16 atol=1e-2), and K2 after K1
   bitwise K1's fused output up to 1,024 columns; the fused attention pass
   on that CSR, D in {8, 256, 300, 1024}, T in {0.7, 1.0}, the three
   normalisations (rtol=1e-5, atol=1e-6, the hub against float64); K2 in
   l2 and l1 modes, D in {8, 256, 300, 1028, 4096}, on rows that include
   an all-zero row (atol=1e-6); K3 bitwise
   against its plain version and the host init on 20,000 random uint64
   hashes (0, 2**64-1 and top-bit values among them), D in {1, 7, 256, 300},
   seed in {0, 7, -3, 2**40+5}; K4 on the same CSR plus a row whose values
   are all 0, D in {8, 256, 300, 1028}, T in {0.7, 1.0} (rtol=1e-5,
   atol=1e-6);
   K5 on the first CSR, D in {8, 136, 256, 300, 4096}, with RandNE's,
   Chebyshev's (z and acc) and Katz's coefficients, and with a separate
   self_ operand (a 3,000-row gather table under a 2,000-row CSR,
   Chebyshev's coefficients, D in {8, 256, 300}) (rtol=1e-5, atol=1e-6:
   the tail is rounded like the plain version's, the row sum in another
   order); K6 at n in {1, 257, 4096} with duplicate entries and an empty
   row (P and deg atol=1e-6, vol rtol=1e-6); K7 on (4096, 4096) and
   (1000, 300), NetMF's and GraRep's modes, with and without scales
   (atol=1e-6: the same float32 operations); K12 bitwise on a random
   weighted 100,000-node CSR with a hub of degree 50,000, a row whose
   weights are all 0, an isolated node and pad lanes, (p, q) in {(0.5, 2),
   (4, 0.25), (0.01, 1), (1, 100)}, 5,000 walks of 10 launched in batches
   of 5,000 and of 1,000; K13 bitwise at (Q, M, C, N) in {(1, 8, 256,
   1000), (37, 8, 256, 100000), (64, 4, 300, 5000) with uint16 codes, (3,
   64, 1024, 2000) with int32 codes, whose tables are gathered from HBM};
   K14 on K1's hub CSR at C in {2, 7, 40, 47} and alpha in {0.5, 0.3}
   (clamped rows bitwise, the rest rtol=1e-5, atol=1e-6: the row sum in
   another order than the plain version's atomics; also whether it equals
   the plain version on the CPU, which adds in edge order); K15's forward
   (h and its packed bits) and backward bitwise at p in {0, 0.5} on odd
   shapes, and against the CPU's; the GCN SpMM's backward (K1 over the transpose, through
   ops/gcn.py's CsrSpmm) against the plain SpMM (rtol=1e-5, atol=1e-6);
4. slice parity: a 20,000-node random graph through the card and through
   device="cpu": embed() unwhitened allclose, whitened Gram matrices of
   2,000 sampled rows, bf16 storage, and the same early-stop iteration under
   a convergence threshold; embed_with_attention unwhitened allclose and
   whitened Gram; embed_multiscale and embed_weighted unwhitened allclose;
   the spectral siblings: _prone_chebyshev_core and
   _device_spmm_weighted_sum allclose (rtol=1e-4, atol=1e-5),
   embed_hope(feature_dim=32) by the Gram matrix of 2,000 rows (atol=5e-3),
   and on a 2,000-node graph embed_netmf and embed_grarep, dense and with
   block_rows=256, by the Gram matrix of all rows (atol=5e-3: unit rows, a
   sketched SVD whose column signs and near-degenerate directions may
   differ between cuSOLVER and LAPACK);
5. full width: bench.py's roadNet-CA-shaped graph (1,965,206 nodes,
   5,533,214 undirected edges, seed 7) ingested through
   SparseMatrix.from_edge_arrays, then the two main paths, each with the
   kernels' launch counts zeroed just before and read just after:
   embed(feature_dim=256, num_iterations=40, whiten=True) (K1 with the
   normalisation fused, no K2) and embed_with_attention(feature_dim=256,
   num_iterations=40, whiten=True) (the fused attention pass), and on
   phase 4's graph embed_with_attention(feature_dim=1028, 3 iterations,
   unwhitened) (K1 then K2, and K2, K4, K1, K2 an iteration), whose output
   is held to the plain chain from the same init and one of whose
   attention steps is held to attention_spmm_plain on the same state
   (rtol=1e-5, atol=1e-6), with K2 and K4 timed at that shape (the
   kernels line's K2 and K4 rows).  Prints each graph's rows over
   LONG_SLICE entries, ingest, host and card init, loop seconds,
   edge-ops/s, per-iteration K1/K2/whiten times and the fused pass against
   the five passes it replaced, peak device memory, torch.sparse.mm's time
   on the same product, and checks each output (finite, covariance close
   to the identity), K3's full-size output bitwise against the host init
   and one full-size K1, K2, K4 and fused-pass call against their plain
   versions; then a power-law Markov CSR of the same size (Chung-Lu,
   exponent 0.9, drawn on the card from seed 7): K1 with its hub slices
   and every row a warp, torch.sparse.mm and the fused pass, timed, the
   rows up to LONG_SLICE entries against the plain versions and the hubs
   against float64 (rtol=1e-5, atol=1e-6; every row a warp to the float32
   bound of a sum in one sequence);
6. the spectral siblings at full width, each through its public entry point
   with backend="device" and the launch counts zeroed before and read
   after: embed_randne (40 iterations) and embed_hope at feature_dim=256
   on phase 5's graph (one run each, under the stage stopwatch);
   embed_netmf and embed_grarep dense at 32,768 nodes and 98,304
   undirected edges (six (n, n) float32 buffers are 25.8 GB) and blocked
   (block_rows=4096, power_iters=1), and embed_prone, at 200,000 nodes and
   600,000 undirected edges (ProNE moved there from phase 5's graph, where
   its float64 host SVD took 45-68 s; phase 12 runs it at full width).
   Returns what phase 12 compares with.  Each entry point runs twice: once
   as a user calls it, which gives the end-to-end seconds, the launch
   counts and the peak device memory, and once more with its stages wrapped
   in a stopwatch that synchronises the device around every call, which
   gives the seconds by stage and nothing else.  Checks each output
   (finite, unit rows) and holds the kernels against their plain versions
   at every shape these paths give them: K5 at D=256 with each coefficient
   set and its Katz step at D=136 on the big graph, K6 and K7 at 32,768
   nodes, and one row block of each blocked path step by step on the
   200,000-node graph's transposed transition CSR (K5 and K1 at
   (200,000, 4,096) on the walk's own states, K7 in NetMF's mode on the
   summed walk and in GraRep's on each power); times them beside one
   library call each;
7. DeepWalk (the walk pipeline), with launch counts zeroed before and read
   after its main path: on a 20,000-node, 60,000-edge parity graph, K8, K9 and K10
   bitwise against their plain versions on the first walk batch (K10 after
   the sweep and after a merge), the walks and the count ranges of the card
   bitwise equal to device="cpu", K11 against its plain version (column
   sums and row pointers bitwise, values rtol=1e-6: another logf), and
   embed_deepwalk with device counting, with host counting and the device
   factorization, and with the host factorization, each by the Gram matrix
   of 2,000 rows against device="cpu" (atol=1e-3: a value perturbation of
   1e-6 moves it by 2e-5 on this graph; the graph is a ring plus random
   edges, connected, because a small component's rows are rounding noise
   after the factorization on any backend), and embed_node2vec(p=0.5, q=2)
   on the same graph: K12's walks bitwise equal on the card and the CPU,
   the same three modes by the Gram matrix (atol=1e-3); at full width,
   scripts/deepwalk_e2e.py's corpus (1,000,000 nodes,
   5,500,000 undirected edges from default_rng(7), 2 walks of 80 per node,
   window 5; num_walks cut from the API's 10 to 2) through
   embed_deepwalk(feature_dim=256, backend="device", cooccurrence="device")
   once untouched and once under the stage stopwatch, the count alone
   (unique pairs within 1 % of the JAX package's 810,145,222 on this
   corpus shape; each of the 8 count ranges' fingerprints equal to those of
   the sort-based merge that K10's merge form replaced), the count
   reductions and the column signs timed alone, K8-K11 against their plain
   versions at the main path's shapes and timed beside torch.sort and
   torch.unique_consecutive (K11's launch apart from its wrapper's checks
   and host read, and its column sums beside index_add_), K10's merge
   form bitwise against its plain version on partition 0's first and last
   chain merge and timed beside the
   sort path it replaced (pack, torch.sort, gather, K10's sweep form), the
   rsvd apply over the 8 PPMI pieces at width 272 by K5's long-row path
   against the short-row path that served it before (K1 + 7 K5 over every
   row; max |diff| within 1e-4 of the largest entry), and K5 over one piece
   against its plain version (rtol=1e-5, atol=1e-6 with the piece's rows
   made left-Markov, as the card tests hold K5; the PPMI values' own
   difference logged) and torch.sparse.mm +
   add_, with both bounds (each input once; one gathered x row an entry);
   and
   scripts/walk_quality_probe.py's 100,000-node, 50-community planted
   partition, whose centroid accuracy must reach 0.99;
8. Node2Vec at full width on phase 7's graph: embed_node2vec(feature_dim=
   256, num_walks=1, walk_length=80, window_size=5, p=0.5, q=2,
   backend="device", cooccurrence="device", factorization="device") once
   untouched (launch counts, peak memory, unit rows) and once under the
   stage stopwatch; the count alone (exactly 769,985,370 pairs, unique
   pairs within 1 % of the JAX package's 295.5 M on this configuration);
   K12 at the main path's batch bitwise against its plain version and
   timed; the planted partition with p=0.5, q=2 (accuracy >= 0.99);
9. retrieval over phase 5's embed() output (1,958,363 x 256 float32):
   ANNIndex(method="device").query_batch and ShardedDeviceIndex (float32,
   bfloat16) of 1,024 table rows at top_k=10 (float32: every top-1 the
   query's own row or a tie within 1e-6, and 64 queries against the host
   brute force: indices equal but for ties within 1e-6, scores atol=1e-5;
   bfloat16, top-1 only: the query's own row or a row whose exact cosine
   with it is within 2^-7 of 1, which 8-bit mantissas cannot order);
   PQIndex with codebooks from product_quantize(M=8, C=256) on 25,000
   sampled rows (a cut: the host k-means of every row would take minutes,
   and of 100,000 rows took 52.6 s) and every row encoded on the card,
   search_batch(backend="device") of the 1,024 queries as a main path (K13
   launched once) against backend="host" on 16 (a cut from 64); K13 at (Q, N) = (1,024,
   1,958,363) bitwise against its plain version and timed; detect_communities_kmeans(k=50) on phase
   8's planted-partition embedding, the card against device="cpu" (labels
   equal on >= 99.9 % of rows);
10. node classification: BASELINE config 3 at full width, the
   ogbn-arxiv-shaped graph of datasets.load_dataset("ogbn_arxiv") (169,343
   nodes, 1,166,243 edges, 40 classes, seed 1001) generated into a
   temporary cache, embed(D=256, 40 iterations, whitened), the centroid
   accuracy of metrics.node_classification_scores (>= 0.99; the JAX
   package recorded 0.998), then as main paths with launch counts, wall
   seconds and peak memory: mlp_classify(hidden_dim=0) (the linear probe,
   library calls only; 10 epochs, a cut from 200), label_propagation_predict (K14 30 times) and
   gcn_classify (K1 3 times an epoch and twice an evaluation, K15's
   forward once an epoch and once an evaluation, its backward once an
   epoch); card against CPU on the same embedding:
   label propagation's predictions equal but for near-ties (top two within
   1e-6), 2 GCN steps at dropout 0.5 (a cut from 5) and one epoch of the
   linear probe
   with parameters within 1e-4 relative; K14 at C = 47 and 40, K15 at
   width 64 and K1 over the GCN operator's transpose at width 64 on phase
   5's 1,958,363-row graph against their plain versions, timed beside
   torch.sparse.mm + tail + where, F.dropout(F.relu) and its autograd
   backward, and torch.sparse.mm;
   BASELINE config 4 (scripts/e2e_configs.py:75-120) card against CPU,
   link-prediction AUC within 0.01;
11. the streamed build and the sharded loop on phase 5's graph: (a) the
   edges written as text and stream-built into a DiskGraph
   (graph.stream.build_graph_streaming), its CSR, values and hashes
   bitwise equal to phase 5's SparseMatrix; (b) embed(DiskGraph) (D=256,
   40 iterations, whitened) without a process group as a main path (K1
   and K2 40 times, K3 once), covariance within 1e-2 of I, the Gram
   matrix of 4,096 sampled rows within 2e-5 of phase 5's embed() output
   and the largest raw difference printed; (c) the same call in a
   one-rank NCCL process group (an in-process store), bitwise equal to
   (b), and embed_sharded(halo=True) there, the halo exchange with the
   shard itself (K16 and all_to_all_single 40 times), bitwise equal to
   (b); (d) a checkpointed run (checkpoint_every=10) cut after 20
   iterations and resumed to 40, bitwise equal to an uninterrupted
   checkpointed run, and out=".npy" equal to (b); (e) K16 on shard 0's
   send slabs of plan_halo(shard_graph(graph, 4)) over phase 5's output
   rows, bitwise against its plain version in float32 and bfloat16,
   timed beside index_select; (f) the CLI in-process: `embed --streaming
   DIR --output x.npy` on phase 10's config-3 edges written as text, by
   Gram against phase 10's embed(), and `info`;
12. the sharded siblings (parallel/algorithms.py) with n_devices=1 in the
   one-rank NCCL group of phase 11, each a main path (launch counts zeroed
   before and read after, end-to-end seconds, seconds by stage, peak
   memory): (a) on phase 5's graph at feature_dim=256, embed_prone,
   embed_randne (40 iterations) and embed_hope with phase 6's K5 counts;
   ProNE's U before its epilogue against _prone_chebyshev_core (rtol=1e-5,
   atol=1e-6), RandNE against phase 6's output (atol=1e-6), HOPE by the
   Gram matrix of 4,096 sampled rows (atol=5e-3); K5 with a separate
   self_ operand at that shape against its plain version and timed, and
   the Gram, CholeskyQR2 (its QᵀQ within 1e-4 of I) and U·√S programs
   timed; (b) embed_prone on phase 6's blocked graph against phase 6's
   run, and with out=".npy" equal to the in-memory result (a cut from
   phase 5's graph, where the out= run took 21-23 s), and embed_netmf and
   embed_grarep (block_rows=4096, power_iters=1) on phase 6's dense graph
   (a cut from the blocked graph, to keep the script near 700 s) against
   the single-device blocked path, each by the Gram matrix of 4,096 rows
   (atol=1e-3);
13. the walk siblings over the shard group in a one-rank NCCL group: (a)
   K17 (kernels/walk_owned.cu) and K18 (kernels/walk2_owned.cu) on phase
   3's weighted 100,000-node graph, the row-sharded tables cut for one
   rank and for two ranks launched in turn and summed in this process,
   4,096 walks of 10 (K18 also over four ranks' slices): the walks
   bitwise equal to K8's and K12's and to the plain versions of K17 and
   K18 run on the card, (p, q) in {(0.5, 2), (2, 0.5)}, K18 at one slice
   one local stage a hop; (b) embed_deepwalk on phase 7's corpus in phase 7's
   configuration with n_devices=1, walk_tables="sharded",
   factorization="sharded" as a main path (K17 79 times a batch): its
   first walk batch bitwise equal to phase 7's (K17 against K8), every
   count range equal to phase 7's (entries, pair sum and a weighted key
   sum), the embedding by the Gram matrix of 4,096 sampled rows against
   phase 7's (atol=1e-4, as the port's CPU tests hold the rsvd; the same
   products in the same order make it bitwise in practice), the rsvd's
   all-reduce timed (its second run, under the stage stopwatch, was cut
   to make room for phase 14); (c) embed_node2vec in
   phase 8's configuration
   with walk_tables="sharded" (K18, one local stage a hop) under the
   stage stopwatch: its first batch bitwise equal to phase 8's K12 walks,
   exactly phase 8's pair count, its K18 launches; (d) K17 over phase 7's
   first batch (131,072 walks of 80) and K18 over phase 8's (131,072
   walks of 10) at one slice and at four slices summed in this process,
   timed against their plain versions on the card (K18 at one slice) and
   K8's and K12's time on the same walks, with their bounds in 32-byte
   sectors and K18's launches a hop; (e) ShardedDeviceIndex(mesh=)
   over phase 5's output, 1,024 queries at top_k=10, equal to the
   unsharded index's scores and, but for exact ties, indices;
14. the overlapped and hierarchical halo exchanges on phase 5's graph and
   output: (a) shard 0 of plan_overlap(shard_graph(graph, 4)) (phase
   11's ShardedCoo and plan_halo): each round's slab packed by K16 from
   its owner's rows in this process and summed by K19 in its round's
   mode (round 0 written over every row, the middle rounds added over
   their compact rows, the last added over every row with a residual mix
   and l2), each round against spmm_acc_plain in float32 and bfloat16
   (rtol=1e-5, atol=1e-6: the row sum in another order than the plain
   version's atomics), the four rounds with l2 in the last against K1
   with l2 fused over shard 0's halo-remapped CSR on the same slabs
   (atol=1e-5), each round timed beside torch.sparse.mm + add_ with its
   bound (and the old design's byte count), and the step (3 packs, 4
   rounds) timed; (b) in a one-rank NCCL group, as main paths,
   embed_sharded(halo="overlap") (K19 40 times, K1 and K2 never; bitwise
   phase 11 (b)'s output, else by the Gram of 4,096 rows within 2e-5, the
   log says which) and embed_sharded(halo="hier", mesh=make_hier_mesh(1,
   1)) (K16 80 times, bitwise phase 11 (b)); K19 at that main path's
   shape (one shard's step: round 0 over every edge and every row,
   written and l2-normalised in one launch) against plain, bitwise K1 with
   l2 fused on the same graph, and both timed; (c) K16 over shard 0's
   send_intra and send_cross of plan_halo_hier(shard_graph(graph, 4), 2,
   2), bitwise against plain and timed; (d) tracing.trace() around one
   embed() iteration and a two-iteration embed_with_attention() on phase
   4's graph, in this process, whose Chrome trace must name the
   annotate() span and hold exactly the port's launches (K1 2, K3 2, the
   fused pass 1), each from the profiler's records or, where the profiler
   lost it (ROADMAP §C1), from its CUDA event pair;
   device_memory_stats()'s bytes_limit equal to mem_get_info()'s total;
   (e) plan_report on phase 5's graph ("fits" at P=1) and on phase 7's
   corpus with walks=True (the walk-table mode phase 7 chose), printed;
   (f) `python -m cleora_tpu_torch scaling --json PATH` as a subprocess,
   its ranks on the card, edges/s printed with the card.  Phases 8 to 14
   print their seconds.

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.  Without a CUDA card the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 (non-tensor-core) FLOP/s — the bounds below use these
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

K1_CHECK_ROWS = 20_000
HUB_DEGREE = 50_000
K3_CHECK_HASHES = 20_000
PARITY_NODES = 20_000
PARITY_EDGES = 60_000
PARITY_SAMPLE = 2_000
FULL_NODES = 1_965_206
FULL_UND_EDGES = 5_533_214
DIM = 256
ITERATIONS = 40
WIDE_DIM = 1_028  # past one column tile: K1 then K2, and K4 for attention
WIDE_ITERATIONS = 3
POWER_LAW_EXPONENT = 0.9  # Chung-Lu endpoint weight (i + 1)^-0.9
SMALL_PARITY_NODES = 2_000
SMALL_PARITY_EDGES = 6_000
DENSE_NODES = 32_768
DENSE_UND_EDGES = 98_304
BLOCKED_NODES = 200_000
BLOCKED_UND_EDGES = 600_000
BLOCK_ROWS = 4_096
GRAREP_STEPS = 4
# phase 7: scripts/deepwalk_e2e.py's defaults (1M nodes, 5.5M undirected
# edges from default_rng(7), 2 walks of 80 per node, window 5), at D=256
WALK_NODES = 1_000_000
WALK_UND_EDGES = 5_500_000
WALKS_PER_NODE = 2
WALK_LENGTH = 80
WINDOW = 5
# unique pairs the JAX package counted on this corpus shape (RESULTS.md:
# 813-838); the port's walks are another stream, so its count is held to 1 %
JAX_UNIQUE_PAIRS = 810_145_222
# range_fingerprint of each of phase 7's count ranges as the sort-based
# chain merge (concatenate, torch.sort, K10) counted them before K10's merge
# form (scripts/torch_count_probe.py --parent, on an H100): the merge form
# must give the same ranges
PHASE7_RANGES = [
    (101370584, 192705464, -283451686025372627),
    (101139824, 192280095, -471666219084290650),
    (101001751, 192037797, -559989136647682646),
    (101109357, 192200668, -410903413773179449),
    (101311164, 192606342, -296430078698956060),
    (101268614, 192490564, -281206758178831419),
    (101482574, 192935571, -62108586126456443),
    (101352177, 192714239, -227893189790885466),
]
# phase 7's skewed piece: hub rows added to a PPMI piece (time_hub_rows)
HUB_ROWS = 16
HUB_ENTRIES = 100_000
WALK_PARITY_LENGTH = 40
WALK_PARITY_DIM = 32
WALK_PARITY_PASSES = 3
# phase 3's K12 check: a weighted graph with phase 3's hub; walks short
# enough that the plain version's rejection rounds (up to 800 per hop at
# q = 100, where the hub's proposals are accepted 1 time in ~200) stay
# within seconds
K12_CHECK_NODES = 100_000
K12_CHECK_WALKS = 5_000
K12_CHECK_BATCHES = (5_000, 1_000)
K12_CHECK_LENGTH = 10
K12_PQ = ((0.5, 2.0), (4.0, 0.25), (0.01, 1.0), (1.0, 100.0))
# phase 3's K13 check: (Q, M, C, N, codes); the last gathers from HBM
K13_CASES = ((1, 8, 256, 1_000, torch.uint8),
             (37, 8, 256, 100_000, torch.uint8),
             (64, 4, 300, 5_000, torch.uint16),
             (3, 64, 1_024, 2_000, torch.int32))
# phase 8: Node2Vec on phase 7's corpus, one walk per node, so that the pair
# count is exactly 999,981 x 770; the JAX package counted 295.5 M unique
# pairs on this configuration (RESULTS.md:87-96)
N2V_P, N2V_Q = 0.5, 2.0
N2V_WALKS = 1
N2V_PAIRS = 769_985_370
JAX_N2V_UNIQUE_PAIRS = 295_500_000
# phase 9: retrieval over phase 5's embed() output
QUERIES = 1_024
TOP_K = 10
# the codebooks' sample, cut from 100,000 rows, whose host k-means took
# 52.6 s of the script's time limit
HELD_QUERIES = 64
# the PQ host search's queries, a cut from 64 (21.9-25.9 s of host time for
# 64 on the card's machines)
PQ_HOST_QUERIES = 16
PQ_SAMPLE = 25_000
PQ_SUBSPACES = 8
PQ_CENTROIDS = 256
KMEANS_K = 50
# phase 3's K14 widths: the class counts of karate (2), cora (7), ogbn-arxiv
# (40) and ogbn-products (47); K15's shapes, odd ones among them
K14_WIDTHS = (2, 7, 40, 47)
K15_SHAPES = ((1, 1), (33, 7), (20_001, 64), (517, 3))
# phase 10: BASELINE config 3 (scripts/e2e_configs.py:57-72), the
# ogbn-arxiv-shaped synthetic graph of datasets.load_ogbn_arxiv, and the
# classifiers at their defaults; the JAX package's centroid accuracy on it
# was 0.998 (RESULTS.md:641-643)
ARXIV_NODES = 169_343
ARXIV_EDGES = 1_166_243
ARXIV_CLASSES = 40
CENTROID_MIN = 0.99
# a cut from mlp_classify's 200 epochs: the probe is host-bound at about
# 1.3 ms per minibatch step on the card's host (136 s for 200 epochs of 530
# steps, PERF.md section 5); the accuracy it reaches is printed
PROBE_EPOCHS = 10
GCN_EPOCHS = 200
LP_ITERATIONS = 30
GCN_PARITY_EPOCHS = 2
LP_PARITY_ITERATIONS = 10  # the card-vs-CPU check's depth (a cut from 30)
GCN_HIDDEN = 64
# K14 at full size: ogbn-products' class count (47) and ogbn-arxiv's (40)
K14_FULL_WIDTHS = (47, 40)
# phase 11: rows of the Gram check, the checkpoint cadence and cut, and
# K16's shard count
STREAM_SAMPLE = 4_096
STREAM_CKPT_EVERY = 10
STREAM_CUT_SAVES = 2
# phase 12: rows of its Gram checks
SHARDED_SAMPLE = 4_096
K16_SHARDS = 4
# scripts/walk_quality_probe.py's defaults
QUALITY_NODES = 100_000
QUALITY_COMMUNITIES = 50
QUALITY_DEG_IN = 8
QUALITY_DEG_OUT = 2
QUALITY_DIM = 64
QUALITY_WALK_LENGTH = 40


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILER_SESSIONS = [0]  # device_busy's sessions in this process


def device_busy(what: str, call, per: int, unit: str) -> None:
    """Device busy share of ``call`` (the union of the kernels'
    intervals, over the wall time), and the kernels that take the time
    (per ``unit``, ``per`` of them in the call), from a tracing.trace()
    trace: every kernel the profiler recorded, and the port's launches
    it lost from their CUDA event pairs (counted in the log line)."""
    import tempfile

    from cleora_tpu_torch.tracing import (
        busy_us,
        kernel_events,
        pair_offsets,
        port_launches,
        trace,
    )

    PROFILER_SESSIONS[0] += 1
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    busy = busy_us(events)
    if not busy:
        log(f"device busy share over {what}: not measured (the trace holds "
            "no device time)")
        return
    by_name = {}
    for e in kernel_events(events):
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    launches = port_launches(events)
    lost = sum(source == "events" for _, source in launches)
    offsets = pair_offsets(events)
    pairs = ("" if not offsets else
             f"; where the profiler has a launch too, its event pair starts "
             f"{offsets['start_us']:.1f} µs before the first kernel and "
             f"adds {offsets['extra_us']:.1f} µs to the kernel time "
             f"(medians of {offsets['launches']})")
    log(f"device busy share over {what}: {busy / wall_us:.3f} "
        f"({busy / 1e3:.3f} of {wall_us / 1e3:.3f} ms; {lost} of the port's "
        f"{len(launches)} launches lost by the profiler, from event pairs"
        f"{pairs})")
    for key, us in sorted(by_name.items(), key=lambda t: -t[1])[:8]:
        log(f"  {us / 1e3 / per:9.3f} ms/{unit}  {key[:90]}")


def device_share(csr, x0, iterations: int = 3) -> None:
    """Device busy share of a few loop iterations."""
    from cleora_tpu_torch.ops.loop import embed_loop

    device_busy(f"{iterations} traced iterations",
                lambda: embed_loop(csr, x0, iterations, 0.0, "l2", True),
                iterations, "it")


def environment() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return card


def build_kernels() -> None:
    from cleora_tpu_torch.kernels import build

    for name in build.KERNELS:  # build from the checkout's sources, always
        if os.path.exists(build.lib_path(name)):
            os.remove(build.lib_path(name))
    t0 = time.perf_counter()
    seconds = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, per kernel "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def markov_csr(n: int, seed: int, hub_degree: int = 0):
    """Random left-Markov CSR (rows sum to 1) with zero-degree rows and,
    optionally, row 1 of degree ``hub_degree``."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(6, size=n)
    deg[::5] = 0
    if hub_degree:
        deg[1] = hub_degree
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n, size=int(indptr[-1]), dtype=np.int64)
    vals = (1.0 / np.maximum(deg, 1))[np.repeat(np.arange(n), deg)]
    return indptr, cols, vals.astype(np.float32)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def k1_check_csr(dev: torch.device, seed: int = 1):
    """Phase 3's CSR: left-Markov rows (a sliced hub sums in another order
    than the plain version, and left-Markov values keep both within
    rtol=1e-5), every fifth row empty, row 1 a hub of HUB_DEGREE entries
    (cut into slices) and the first other non-empty row with every value
    0.  Returns (csr, that row)."""
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    indptr, cols, vals = markov_csr(K1_CHECK_ROWS, seed, HUB_DEGREE)
    deg = np.diff(indptr)
    zero_row = int(np.flatnonzero(deg[2:] > 0)[0]) + 2
    vals[indptr[zero_row]:indptr[zero_row + 1]] = 0.0
    return CsrMatrix.from_numpy(indptr, cols, vals, dev), zero_row


def check_k1(dev: torch.device, csr, zero_row: int) -> None:
    """K1 against spmm_plain + the plain normalisation: D 8, 256, 300,
    1028 and 4096 (K1 then K2 past 1,024 columns), float32 and bf16 x, w 0
    and 0.3, l2, l1 and none; the hub in slices and (D 256) walked by its
    own warp, held in float32 to its float64 reference."""
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.normalize import normalize, normalize_plain
    from cleora_tpu_torch.ops.spmm import spmm, spmm_plain

    assert csr.hub_plan().split.shape[0] == 1  # the hub, in slices
    hub = (csr.indptr[1:] - csr.indptr[:-1]) > kernels.LONG_SLICE
    hub_ids = torch.nonzero(hub).flatten()
    gen = torch.Generator(device=dev).manual_seed(0)
    for d in (8, 256, 300, WIDE_DIM, 4096):
        x32 = torch.randn((K1_CHECK_ROWS, d), device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for w in (0.0, 0.3):
                for norm in ("none", "l2", "l1"):
                    got = spmm(csr, x, w, normalization=norm)
                    want = normalize_plain(spmm_plain(csr, x, w), norm)
                    torch.cuda.synchronize()
                    if dtype == torch.float32:
                        ref, _ = hub_rows_float64(csr, x, hub_ids, w=w,
                                                  norm=norm)
                        errs = assert_rows_close(got, want, hub, ref)
                    else:
                        torch.testing.assert_close(got, want, rtol=0.0,
                                                   atol=1e-2)
                        errs = f"max |err| {max_err(got, want):.3e}"
                    if w == 0.0:
                        assert torch.all(got[zero_row] == 0.0)
                    if norm != "none" and d <= 1024:
                        # K2 after K1 repeats K1's epilogue bit for bit
                        # (halo="overlap" normalises K19's sums with K2)
                        assert torch.equal(
                            normalize(spmm(csr, x, w), norm), got)
                    log(f"K1 d={d} {str(dtype)[6:]} w={w} {norm}: {errs}")
        if d == 256:  # every row its own warp, the hub too
            for norm in ("none", "l2"):
                got = kernels.spmm_csr(csr.indptr, csr.indices, csr.vals,
                                       x32, 0.0, None, norm, None)
                want = normalize_plain(spmm_plain(csr, x32), norm)
                torch.cuda.synchronize()
                ref, _ = hub_rows_float64(csr, x32, hub_ids, norm=norm)
                errs = assert_rows_close(got, want, hub, ref)
                log(f"K1 d={d} no slices {norm}: {errs}")


def hub_rows_float64(csr, x, rows, temperature=None, w: float = 0.0,
                     norm: str = "none") -> tuple:
    """A float64 reference on a few (hub) ``rows``, one row at a time:
    K1's ``(1-w) A x + w x`` (``temperature`` None) or the fused attention
    pass's propagate (JAX's masked softmax, reweighting and
    renormalisation, then the weighted sum), then the row normalisation
    ``norm``.  Returns (reference, sum of |term| of each unnormalised
    element), the second for the float32 summation bound."""
    xd = x.double()
    out, mag = [], []
    for r in rows.tolist():
        lo, hi = int(csr.indptr[r]), int(csr.indptr[r + 1])
        cols = csr.indices[lo:hi].long()
        v = csr.vals[lo:hi].double()
        xc = xd.index_select(0, cols)
        if temperature is not None:
            xr = xd[r] / xd[r].norm().clamp_min(1e-10)
            s = (xc @ xr) / xc.norm(dim=1).clamp_min(1e-10) / temperature
            valid = v != 0
            top = s[valid].max() if bool(valid.any()) else 0.0
            p = torch.where(valid, torch.exp(s - top), 0.0)
            v = p / p.sum().clamp_min(1e-10) * v
            v = v / v.sum().clamp_min(1e-10)
        y = v @ xc
        if w > 0.0:
            y = (1.0 - w) * y + w * xd[r]
        if norm == "l2":
            y = y / y.norm().clamp_min(1e-10)
        elif norm == "l1":
            y = y / y.abs().sum().clamp_min(1e-10)
        out.append(y)
        mag.append(v.abs() @ xc.abs())
        del xc
    return torch.stack(out), torch.stack(mag)


def assert_rows_close(got, want, hub, ref) -> str:
    """A kernel against its plain version at rtol=1e-5, atol=1e-6 on
    every row but the hubs (boolean ``hub``: more than LONG_SLICE
    entries), and on the hubs against the float64 reference ``ref`` of
    those rows (hub_rows_float64) at the same tolerance: the plain
    version's float32 atomics add a hub's tens or hundreds of thousands
    of terms in an order of their own, which parts from the exact sum by
    more than the kernel's slices do (on an H100, the power-law graph's
    hubs: K1 5.4e-8 from float64, the plain version 1.4e-6).  Returns the
    errors for the log, the plain version's on the hubs included."""
    hub_ids = torch.nonzero(hub).flatten()
    torch.testing.assert_close(got[~hub], want[~hub], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[hub_ids].double(), ref, rtol=1e-5,
                               atol=1e-6)
    return (f"max |err| {max_err(got[~hub], want[~hub]):.3e}, hub rows "
            f"against float64 {max_err(got[hub_ids].double(), ref):.3e} "
            f"(the plain version {max_err(want[hub_ids].double(), ref):.3e})")


def check_attention(dev: torch.device, csr, zero_row: int) -> None:
    """The fused attention pass against attention_spmm_plain (K4's plain
    weights, spmm_plain, the plain normalisation), the hub against its
    float64 reference: D 8, 256, 300 and 1024, T 0.7 and 1.0, l2, l1 and
    none; the hub in slices and (D 256) by its own warp; the row whose
    values are all 0 gives 0."""
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.attention import (
        attention_spmm,
        attention_spmm_plain,
    )

    hub = (csr.indptr[1:] - csr.indptr[:-1]) > kernels.LONG_SLICE
    hub_ids = torch.nonzero(hub).flatten()
    gen = torch.Generator(device=dev).manual_seed(2)
    for d in (8, 256, 300, 1024):
        x = torch.randn((K1_CHECK_ROWS, d), device=dev, generator=gen)
        for temperature in (0.7, 1.0):
            for norm in ("none", "l2", "l1"):
                got = attention_spmm(csr, x, temperature, norm)
                want = attention_spmm_plain(csr, x, temperature, norm)
                torch.cuda.synchronize()
                ref, _ = hub_rows_float64(csr, x, hub_ids, temperature,
                                          norm=norm)
                errs = assert_rows_close(got, want, hub, ref)
                assert torch.all(got[zero_row] == 0.0)
                log(f"attention d={d} T={temperature} {norm}: {errs}")
        if d == 256:
            got = kernels.attention_spmm(csr.indptr, csr.indices, csr.vals,
                                         x, 1.0, "l2", None)
            want = attention_spmm_plain(csr, x, 1.0, "l2")
            torch.cuda.synchronize()
            ref, _ = hub_rows_float64(csr, x, hub_ids, 1.0, norm="l2")
            errs = assert_rows_close(got, want, hub, ref)
            log(f"attention d={d} no slices l2: {errs}")


def check_kernels(dev: torch.device) -> None:
    from cleora_tpu_torch.ops.normalize import (
        l1_normalize_plain,
        l2_normalize_plain,
        normalize,
    )
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    csr, zero_row = k1_check_csr(dev)
    check_k1(dev, csr, zero_row)
    check_attention(dev, csr, zero_row)
    gen = torch.Generator(device=dev).manual_seed(0)
    for d in (8, 256, 300, WIDE_DIM, 4096):
        x32 = torch.randn((K1_CHECK_ROWS, d), device=dev, generator=gen)
        x32[7] = 0.0
        for method, plain in (("l2", l2_normalize_plain),
                              ("l1", l1_normalize_plain)):
            got = normalize(x32.clone(), method)
            want = plain(x32.clone())
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)
            assert torch.all(got[7] == 0.0)
            log(f"K2 d={d} {method}: max |err| {max_err(got, want):.3e}")
    csr = CsrMatrix.from_numpy(*markov_csr(K1_CHECK_ROWS, 1, HUB_DEGREE), dev)
    check_k3(dev)
    check_k4(dev)
    check_k5(dev, csr)
    check_k6(dev)
    check_k7(dev)
    check_k12(dev)
    check_k13(dev)
    check_k14(dev, csr)
    check_k15(dev)
    check_gcn_backward(dev, csr)


def label_state(n: int, c: int, dev: torch.device, seed: int):
    """Random F in [0, 1), one-hot Y on about 30 % of the rows and their
    mask, as label propagation gives K14."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = torch.rand((n, c), device=dev, generator=gen)
    mask = torch.rand((n,), device=dev, generator=gen) < 0.3
    y = torch.zeros((n, c), device=dev)
    cls = torch.randint(0, c, (n,), device=dev, generator=gen)
    y[mask, cls[mask]] = 1.0
    return f, y, mask


def check_k14(dev: torch.device, csr) -> None:
    """K14 against its plain version on the hub CSR: clamped rows bitwise,
    the rest rtol=1e-5, atol=1e-6 (the row sum in another order than the
    plain version's atomics, about 7e-6 relative on the hub's 50,000
    edges); also whether it equals the plain version run on the CPU, which
    adds in edge order as K14 does."""
    from cleora_tpu_torch.ops.label_prop import (
        label_prop_step,
        label_prop_step_plain,
    )
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    host = CsrMatrix(csr.indptr.cpu(), csr.indices.cpu(), csr.vals.cpu())
    for c in K14_WIDTHS:
        f, y, mask = label_state(csr.n_rows, c, dev, 14 + c)
        for alpha in (0.5, 0.3):
            beta = float(np.float32(1) - np.float32(alpha))
            got = label_prop_step(csr, f, y, mask, alpha, beta)
            want = label_prop_step_plain(csr, f, y, mask, alpha, beta)
            torch.cuda.synchronize()
            assert torch.equal(got[mask], y[mask]), c
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            rel = float(((got - want).abs()
                         / want.abs().clamp_min(1e-30)).max())
            on_cpu = label_prop_step_plain(host, f.cpu(), y.cpu(), mask.cpu(),
                                           alpha, beta)
            log(f"K14 C={c} alpha={alpha}: max |err| {max_err(got, want):.3e}"
                f", max relative {rel:.3e}, clamped rows bitwise; bitwise "
                f"equal to the plain version on the CPU: "
                f"{torch.equal(got.cpu(), on_cpu)}")


def check_k15(dev: torch.device) -> None:
    """K15's forward (h and the packed bits) and backward bitwise against
    their plain versions, on the card and against the CPU's."""
    from cleora_tpu_torch.ops.gcn import (
        relu_dropout,
        relu_dropout_backward,
        relu_dropout_backward_plain,
        relu_dropout_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(15)
    for shape in K15_SHAPES:
        z = torch.randn(shape, device=dev, generator=gen)
        z[0, 0] = 0.0
        dh = torch.randn(shape, device=dev, generator=gen)
        for p in (0.0, 0.5):
            for epoch, layer, seed in ((0, 0, 42), (199, 1, 2**40 + 3)):
                args = (p, seed, epoch, layer)
                h, mask = relu_dropout(z, *args)
                dz = relu_dropout_backward(mask, dh, p)
                torch.cuda.synchronize()
                h_plain, mask_plain = relu_dropout_plain(z, *args)
                assert torch.equal(h, h_plain), shape
                assert torch.equal(mask, mask_plain), shape
                assert torch.equal(
                    dz, relu_dropout_backward_plain(mask, dh, p)), shape
                h_cpu, mask_cpu = relu_dropout_plain(z.cpu(), *args)
                assert torch.equal(h.cpu(), h_cpu)
                assert torch.equal(mask.cpu(), mask_cpu)
            kept = float(((h != 0).sum() / (z > 0).sum().clamp_min(1)))
            log(f"K15 {shape} p={p}: forward (h and the packed bits) and "
                "backward bitwise equal to plain (and to the CPU's); kept "
                f"{kept:.4f} of the positive entries")


def check_gcn_backward(dev: torch.device, csr) -> None:
    """The GCN SpMM's backward (K1 over the transpose) against the plain
    SpMM over the transpose, on the hub CSR, rtol=1e-5, atol=1e-6."""
    from cleora_tpu_torch.ops.gcn import CsrSpmm
    from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm, spmm_plain

    n = csr.n_rows
    rows = np.repeat(np.arange(n), np.diff(csr.indptr.cpu().numpy()))
    cols, vals = csr.indices.cpu().numpy(), csr.vals.cpu().numpy()
    a = CsrMatrix.from_coo(rows, cols, vals, n, dev)
    at = CsrMatrix.transpose_from_coo(rows, cols, vals, n, dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    h = torch.randn((n, GCN_HIDDEN), device=dev, generator=gen,
                    requires_grad=True)
    w = torch.randn((n, GCN_HIDDEN), device=dev, generator=gen)
    (CsrSpmm.apply(h, a, at) * w).sum().backward()
    want = spmm_plain(at, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(h.grad, want, rtol=1e-5, atol=1e-6)
    assert max_err(spmm(a, w), h.grad) > 1e-3  # A is not symmetric
    log(f"CsrSpmm backward (K1 over the transpose) d={GCN_HIDDEN}: max |err| "
        f"{max_err(h.grad, want):.3e} against plain")


def check_k3(dev: torch.device) -> None:
    from cleora_tpu_torch.graph.hashing import init_embeddings
    from cleora_tpu_torch.ops.init import (
        device_init,
        device_init_plain,
        hashes_as_int64,
    )

    h = np.random.default_rng(2).integers(
        0, 2**64 - 1, size=K3_CHECK_HASHES, dtype=np.uint64, endpoint=True)
    h[:5] = [0, 2**64 - 1, 2**63, 2**63 - 1, 2**63 + 1]
    t = hashes_as_int64(h).to(dev)
    for d in (1, 7, 256, 300):
        for seed in (0, 7, -3, 2**40 + 5):
            got = device_init(t, d, seed)
            want = device_init_plain(t, d, seed)
            host = init_embeddings(h, d, seed)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (d, seed)
            assert got.cpu().numpy().tobytes() == host.tobytes(), (d, seed)
        log(f"K3 d={d}: bitwise equal to its plain version and the host init "
            "for seeds 0, 7, -3, 2**40+5")


def check_k4(dev: torch.device) -> None:
    from cleora_tpu_torch.ops.attention import (
        edge_attention_weights,
        edge_attention_weights_plain,
    )
    from cleora_tpu_torch.ops.normalize import l2_normalize_plain
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    indptr, cols, vals = markov_csr(K1_CHECK_ROWS, 1, HUB_DEGREE)
    deg = np.diff(indptr)
    zero_row = int(np.flatnonzero(deg[2:] > 0)[0]) + 2
    vals[indptr[zero_row]:indptr[zero_row + 1]] = 0.0
    csr = CsrMatrix.from_numpy(indptr, cols, vals, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for d in (8, 256, 300, WIDE_DIM):
        xn = l2_normalize_plain(
            torch.randn((K1_CHECK_ROWS, d), device=dev, generator=gen))
        for temperature in (0.7, 1.0):
            got = edge_attention_weights(csr, xn, temperature)
            want = edge_attention_weights_plain(csr, xn, temperature)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            zero = got[int(indptr[zero_row]):int(indptr[zero_row + 1])]
            assert torch.all(zero == 0.0)
            log(f"K4 d={d} T={temperature}: max |err| "
                f"{max_err(got, want):.3e}")


# K5's check with a separate self_ operand: a shard's CSR rows under its
# gather table's rows
K5_SELF_ROWS = 2_000
K5_SELF_TABLE = 3_000
# K5's coefficient sets: (a, b, c, d, takes z, takes acc)
K5_CASES = {
    "randne": (1.0, 0.0, 0.0, 0.25, False, True),
    "chebyshev": (-2.0, 2.0, -1.0, 0.0497, True, True),
    "katz": (0.1, 0.0, 0.0, 1.0, False, True),
}


def k5_pair(csr, x, z, acc, case: str):
    """One K5 call and its plain version on the same inputs; returns
    (out, acc) of each."""
    from cleora_tpu_torch.ops.spmm import spmm_axpy, spmm_axpy_plain

    a, b, c, d, has_z, has_acc = K5_CASES[case]
    got_acc = acc.clone() if has_acc else None
    want_acc = acc.clone() if has_acc else None
    got = spmm_axpy(csr, x, a, b, z=z if has_z else None, c=c, acc=got_acc,
                    d=d)
    want = spmm_axpy_plain(csr, x, a, b, z=z if has_z else None, c=c,
                           acc=want_acc, d=d)
    torch.cuda.synchronize()
    return (got, got_acc), (want, want_acc)


def k5_self_pair(csr, table, own, z, acc):
    """K5 with a separate ``self_`` operand (the sharded siblings' call:
    the SpMM gathers from ``table``, ``b·self_`` reads ``own``) and its
    plain version, with Chebyshev's coefficients; returns (out, acc) of
    each."""
    from cleora_tpu_torch.ops.spmm import spmm_axpy, spmm_axpy_plain

    a, b, c, d = K5_CASES["chebyshev"][:4]
    got_acc, want_acc = acc.clone(), acc.clone()
    got = spmm_axpy(csr, table, a, b, z=z, c=c, acc=got_acc, d=d,
                    self_=own)
    want = spmm_axpy_plain(csr, table, a, b, z=z, c=c, acc=want_acc, d=d,
                           self_=own)
    torch.cuda.synchronize()
    return (got, got_acc), (want, want_acc)


def check_k5(dev: torch.device, csr) -> None:
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    gen = torch.Generator(device=dev).manual_seed(5)
    n = csr.n_rows
    for d in (8, 136, 256, 300, 4096):
        x, z, acc = (torch.randn((n, d), device=dev, generator=gen)
                     for _ in range(3))
        for case in K5_CASES:
            got, want = k5_pair(csr, x, z, acc, case)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
            log(f"K5 d={d} {case}: max |err| out {max_err(got[0], want[0]):.3e}"
                f", acc {max_err(got[1], want[1]):.3e}")
    # a 3,000-row gather table under a 2,000-row CSR, as a shard's
    indptr, _, vals = markov_csr(K5_SELF_ROWS, 6, 500)
    cols = np.random.default_rng(6).integers(0, K5_SELF_TABLE, len(vals))
    rect = CsrMatrix(torch.from_numpy(indptr).to(dev),
                     torch.from_numpy(cols.astype(np.int32)).to(dev),
                     torch.from_numpy(vals).to(dev))
    for d in (8, 256, 300):
        table = torch.randn((K5_SELF_TABLE, d), device=dev, generator=gen)
        own, z, acc = (torch.randn((K5_SELF_ROWS, d), device=dev,
                                   generator=gen) for _ in range(3))
        got, want = k5_self_pair(rect, table, own, z, acc)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        log(f"K5 d={d} chebyshev, self_ ({K5_SELF_ROWS} rows under a "
            f"{K5_SELF_TABLE}-row table): max |err| out "
            f"{max_err(got[0], want[0]):.3e}, acc "
            f"{max_err(got[1], want[1]):.3e}")


def duplicate_csr(n: int, seed: int):
    """Row-sorted CSR arrays with repeated (row, col) entries and an empty
    row (row 3, where there is one)."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(6, size=n) + 1
    if n > 3:
        deg[3] = 0
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n, size=int(indptr[-1]), dtype=np.int64)
    for r in range(0, n, 2):  # every other row repeats its first column
        if deg[r] > 1:
            cols[indptr[r] + 1] = cols[indptr[r]]
    vals = rng.random(int(indptr[-1])).astype(np.float32)
    return indptr, cols, vals


def check_dense_markov(csr) -> float:
    """K6 against its plain version on ``csr``; returns the largest error
    of P."""
    from cleora_tpu_torch.ops.dense import dense_markov, dense_markov_plain

    p, deg, vol = dense_markov(csr)
    p_plain, deg_plain, vol_plain = dense_markov_plain(csr)
    torch.cuda.synchronize()
    torch.testing.assert_close(p, p_plain, rtol=0.0, atol=1e-6)
    torch.testing.assert_close(deg, deg_plain, rtol=0.0, atol=1e-6)
    torch.testing.assert_close(vol, vol_plain, rtol=1e-6, atol=0.0)
    return max_err(p, p_plain)


def check_k6(dev: torch.device) -> None:
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    for n in (1, 257, 4096):
        csr = CsrMatrix.from_numpy(*duplicate_csr(n, n), dev)
        err = check_dense_markov(csr)
        log(f"K6 n={n} ({csr.nnz} entries, duplicates, an empty row): "
            f"max |err| P {err:.3e}")


def grarep_mode():
    from cleora_tpu_torch.algorithms import _GRAREP_FLOOR, _GRAREP_OFFSET

    return _GRAREP_FLOOR, _GRAREP_OFFSET


def check_log_clip(x, r, c, floor: float, offset: float) -> float:
    """K7 against its plain version on copies of ``x``; returns the largest
    error."""
    from cleora_tpu_torch.ops.dense import log_clip, log_clip_plain

    got = log_clip(x.clone(), r, c, floor, offset)
    want = log_clip_plain(x.clone(), r, c, floor, offset)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)
    return max_err(got, want)


def check_k7(dev: torch.device) -> None:
    gen = torch.Generator(device=dev).manual_seed(7)
    modes = {"netmf": (1.0, 0.0), "grarep": grarep_mode()}
    for n, m in ((4096, 4096), (1000, 300)):
        x = torch.rand((n, m), device=dev, generator=gen) * 4
        x[x < 1.0] = 0.0  # a transition power is mostly zeros
        r = torch.rand(n, device=dev, generator=gen) + 0.5
        c = torch.rand(m, device=dev, generator=gen) + 0.5
        for mode, (floor, offset) in modes.items():
            for scaled in (True, False):
                err = check_log_clip(x, r if scaled else None,
                                     c if scaled else None, floor, offset)
                log(f"K7 ({n}, {m}) {mode} scales={scaled}: max |err| "
                    f"{err:.3e}")


def weighted_walk_tables(n: int, seed: int, dev: torch.device,
                         hub_degree: int):
    """The tables of :func:`weighted_walk_csr` on ``dev``."""
    from cleora_tpu_torch.ops.walk import WalkTables2

    indptr, cols, deg, vals, wmax, wsum = weighted_walk_csr(n, seed,
                                                            hub_degree)
    return WalkTables2(indptr, cols, deg, n, vals, wmax, wsum, dev)


def weighted_walk_csr(n: int, seed: int, hub_degree: int) -> tuple:
    """A weighted walk CSR with (row, col)-sorted rows, as host arrays
    (indptr, cols, deg, vals, wmax, wsum): node 1 a hub of degree
    ``hub_degree``, node 2 a row whose weights are all 0 (a dead row), node
    n - 1 isolated (degree 0)."""
    rng = np.random.default_rng(seed)
    m = 3 * n
    src = np.concatenate([rng.integers(0, n - 1, m),
                          np.ones(hub_degree, np.int64)])
    dst = np.concatenate([rng.integers(0, n - 1, m),
                          rng.choice(n - 1, hub_degree, replace=False)])
    keys = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    rows, cols = keys // n, keys % n
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(0.05, 3.0, rows.shape[0]).astype(np.float32)
    vals[rows == 2] = 0.0
    deg = np.bincount(rows, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)[:-1]])
    wmax = np.zeros(n, np.float32)
    np.maximum.at(wmax, rows, vals)
    wsum = np.zeros(n, np.float64)
    np.add.at(wsum, rows, vals.astype(np.float64))
    return indptr, cols, deg, vals, wmax, wsum.astype(np.float32)


def check_k12(dev: torch.device) -> None:
    """K12 against its plain version, bitwise, for four (p, q), the walks
    launched in two batch sizes."""
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.walk import walk2_tries, walk_p_q_plain

    n = K12_CHECK_NODES
    t = weighted_walk_tables(n, 5, dev, HUB_DEGREE)
    assert int(t.deg[1]) >= HUB_DEGREE and int(t.deg[n - 1]) == 0
    rng = np.random.default_rng(6)
    starts = rng.integers(0, n + 1, K12_CHECK_WALKS)  # n: pad lanes
    for i, node in enumerate((1, 2, n - 1, n)):  # hub, dead, isolated, pad
        starts[64 * i:64 * (i + 1)] = node
    starts = torch.from_numpy(starts.astype(np.int32)).to(dev)
    tables = (t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum)
    for p, q in K12_PQ:
        walk = (K12_CHECK_LENGTH, 1.0 / p, 1.0 / q, walk2_tries(q), 11)
        t0 = time.perf_counter()
        want = walk_p_q_plain(*tables, starts, *walk, 0, n)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for batch in K12_CHECK_BATCHES:
            got = torch.cat([
                kernels.walk_p_q(*tables, starts[lo:lo + batch], *walk, lo, n)
                for lo in range(0, K12_CHECK_WALKS, batch)])
            torch.cuda.synchronize()
            assert torch.equal(got, want), (p, q, batch)
        assert torch.all(want[64:128, 1:] == n)  # the dead row stops
        assert torch.all(want[128:256, 1:] == n)  # isolated node, pad lanes
        hub_hops = int((want[:, :-1] == 1).sum())
        log(f"K12 p={p} q={q} tries={walk[3]}: {K12_CHECK_WALKS} walks of "
            f"{K12_CHECK_LENGTH} (hub of degree {int(t.deg[1])} left "
            f"{hub_hops} times) bitwise equal to plain in batches of "
            f"{K12_CHECK_BATCHES} (plain {plain_s:.1f} s)")


def check_k13(dev: torch.device) -> None:
    """K13 against its plain version, bitwise."""
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.pq import pq_adc_plain

    gen = torch.Generator(device=dev).manual_seed(4)
    for q, m, c, n, dtype in K13_CASES:
        tables = torch.randn((q, m, c), device=dev, generator=gen)
        codes = torch.randint(0, c, (n, m), device=dev, generator=gen,
                              dtype=torch.int32).to(dtype)
        got = kernels.pq_adc(tables, codes)
        want = pq_adc_plain(tables, codes)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (q, m, c, n, dtype)
        log(f"K13 (Q, M, C, N) = ({q}, {m}, {c}, {n}) {str(dtype)[6:]} "
            "codes: bitwise equal to plain")


def random_graph(n_nodes: int, n_und_edges: int, seed: int,
                 cover: bool = False):
    """bench.py's synthetic_coo edge draw, as a SparseMatrix.  ``cover``
    makes node i the source of edge i, so that every node appears and the
    graph has exactly ``n_nodes`` entities."""
    import cleora_tpu_torch as ctt

    return ctt.SparseMatrix.from_edge_arrays(
        *synthetic_edges(n_nodes, n_und_edges, seed, cover))


def synthetic_edges(n_nodes: int, n_und_edges: int, seed: int,
                    cover: bool = False):
    """(src, dst) int64 of bench.py's synthetic_coo edge draw."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_und_edges, dtype=np.int64)
    dst = rng.integers(0, n_nodes, size=n_und_edges, dtype=np.int64)
    if cover:
        src[:n_nodes] = np.arange(n_nodes)
    return src, dst


def slice_parity(dev: torch.device) -> None:
    import cleora_tpu_torch as ctt

    g = random_graph(PARITY_NODES, PARITY_EDGES, seed=3)
    cpu = torch.device("cpu")
    kw = dict(feature_dim=DIM, num_iterations=ITERATIONS, whiten=False)
    a = ctt.embed(g, device=dev, **kw)
    b = ctt.embed(g, device=cpu, **kw)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity unwhitened ({g.num_entities} nodes, {ITERATIONS} it): "
        f"max |err| {np.abs(a - b).max():.3e}")

    kw = dict(feature_dim=DIM, num_iterations=5, whiten=True)
    a = ctt.embed(g, device=dev, **kw)
    b = ctt.embed(g, device=cpu, **kw)
    assert np.isfinite(a).all()
    rows = np.random.default_rng(0).choice(g.num_entities, PARITY_SAMPLE,
                                           replace=False)
    err, scale = gram_err(a, b, rows)
    log(f"parity whitened Gram ({PARITY_SAMPLE} rows, 5 it): max |err| "
        f"{err:.3e} of max |G| {scale:.3e}")
    assert err <= 1e-4 * scale, (err, scale)

    kw = dict(feature_dim=DIM, num_iterations=5, whiten=False,
              dtype="bfloat16")
    a = ctt.embed(g, device=dev, **kw)
    b = ctt.embed(g, device=cpu, **kw)
    np.testing.assert_allclose(a, b, rtol=0.0, atol=2e-2)
    log(f"parity bfloat16 storage (5 it): max |err| {np.abs(a - b).max():.3e}")

    its = [g.embed_fast_convergence(DIM, ITERATIONS,
                                    convergence_threshold=1e-3, device=d)[1]
           for d in (dev, cpu)]
    log(f"parity convergence: stops after {its[0]} (card) / {its[1]} (cpu) "
        "iterations")
    assert its[0] == its[1] and 1 < its[0] < ITERATIONS, its

    kw = dict(feature_dim=DIM, num_iterations=10, attention_temperature=0.7,
              whiten=False)
    a = ctt.embed_with_attention(g, device=dev, **kw)
    b = ctt.embed_with_attention(g, device=cpu, **kw)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity embed_with_attention unwhitened (10 it): max |err| "
        f"{np.abs(a - b).max():.3e}")
    kw = dict(feature_dim=DIM, num_iterations=5, whiten=True)
    a = ctt.embed_with_attention(g, device=dev, **kw)
    b = ctt.embed_with_attention(g, device=cpu, **kw)
    assert np.isfinite(a).all()
    err, scale = gram_err(a, b, rows)
    log(f"parity embed_with_attention whitened Gram ({PARITY_SAMPLE} rows, "
        f"5 it): max |err| {err:.3e} of max |G| {scale:.3e}")
    assert err <= 1e-4 * scale, (err, scale)

    kw = dict(feature_dim=DIM, scales=[3, 10], whiten=False)
    a = ctt.embed_multiscale(g, device=dev, **kw)
    b = ctt.embed_multiscale(g, device=cpu, **kw)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity embed_multiscale (scales 3, 10): max |err| "
        f"{np.abs(a - b).max():.3e}")

    rng = np.random.default_rng(5)
    ends = rng.integers(0, PARITY_NODES, size=(PARITY_EDGES, 2))
    weights = rng.uniform(0.5, 3.0, size=PARITY_EDGES)
    edges = [(f"{s} {d}", float(w)) for (s, d), w in zip(ends, weights)]
    kw = dict(feature_dim=DIM, num_iterations=10, whiten=False)
    a = ctt.embed_weighted(edges, "complex::reflexive::node", device=dev,
                           **kw)[1]
    b = ctt.embed_weighted(edges, "complex::reflexive::node", device=cpu,
                           **kw)[1]
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity embed_weighted (10 it): max |err| {np.abs(a - b).max():.3e}")
    spectral_parity(dev, g, rows)


def spectral_parity(dev: torch.device, g, rows: np.ndarray) -> None:
    """The spectral siblings on the card against device="cpu"."""
    import cleora_tpu_torch.algorithms as alg

    cpu = torch.device("cpu")
    a = alg._prone_chebyshev_core(g, DIM, 0.2, 0.5, 0, dev).cpu().numpy()
    b = alg._prone_chebyshev_core(g, DIM, 0.2, 0.5, 0, cpu).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity _prone_chebyshev_core: max |err| {np.abs(a - b).max():.3e}")
    R = np.random.default_rng(0).standard_normal((g.num_entities, DIM))
    w = [1.0 / 2**i for i in range(ITERATIONS + 1)]
    a = alg._device_spmm_weighted_sum(g, R, w, True, dev)
    b = alg._device_spmm_weighted_sum(g, R, w, True, cpu)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity _device_spmm_weighted_sum ({ITERATIONS} it): max |err| "
        f"{np.abs(a - b).max():.3e}")
    kw = dict(feature_dim=32, backend="device")
    a = alg.embed_hope(g, device=dev, **kw)
    b = alg.embed_hope(g, device=cpu, **kw)
    err, scale = gram_err(a, b, rows)
    log(f"parity embed_hope Gram ({PARITY_SAMPLE} rows): max |err| {err:.3e} "
        f"of max |G| {scale:.3e}")
    assert np.isfinite(a).all() and err <= 5e-3, err

    small = random_graph(SMALL_PARITY_NODES, SMALL_PARITY_EDGES, seed=4)
    every = np.arange(small.num_entities)
    for name in ("netmf", "grarep"):
        fn = getattr(alg, f"embed_{name}")
        for block_rows in (None, 256):
            kw = dict(feature_dim=DIM, backend="device",
                      block_rows=block_rows)
            a = fn(small, device=dev, **kw)
            b = fn(small, device=cpu, **kw)
            err, scale = gram_err(a, b, every)
            log(f"parity embed_{name} block_rows={block_rows} Gram "
                f"({small.num_entities} rows): max |err| {err:.3e} of max "
                f"|G| {scale:.3e}")
            assert np.isfinite(a).all() and err <= 5e-3, err


def sample_rows(n: int, seed: int = 13) -> np.ndarray:
    """Sorted rows of phase 12's Gram checks, the same for both runs."""
    return np.sort(np.random.default_rng(seed).choice(
        n, size=min(SHARDED_SAMPLE, n), replace=False))


def gram_err(a: np.ndarray, b: np.ndarray, rows: np.ndarray):
    """Largest difference of the two row Gram matrices over ``rows``, and
    the largest entry of the second."""
    ga = a[rows].astype(np.float64) @ a[rows].T.astype(np.float64)
    gb = b[rows].astype(np.float64) @ b[rows].T.astype(np.float64)
    return np.abs(ga - gb).max(), np.abs(gb).max()


def check_covariance(out: np.ndarray, dev: torch.device) -> None:
    """A whitened output: finite, and its covariance within 1e-2 of I."""
    n = out.shape[0]
    assert out.shape == (n, DIM) and np.isfinite(out).all()
    o = torch.from_numpy(out).to(dev, torch.float64)
    oc = o - o.mean(dim=0)
    cov = oc.T @ oc / (n - 1)
    cov_err = float((cov - torch.eye(DIM, device=dev,
                                     dtype=torch.float64)).abs().max())
    log(f"output covariance: max |cov - I| {cov_err:.3e}")
    assert cov_err <= 1e-2


def run_main_path(name: str, call) -> tuple:
    """Drives one main path with every launch count zeroed just before and
    read just after; returns (output, launches)."""
    from cleora_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = call()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"{name}: {wall_s:.3f} s end to end, launches {launches}, "
        f"peak device memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB "
        "held before the call)")
    return out, launches


def kernel_row(name, source, replaces, ms, plain_ms, lib_ms, err, nbytes,
               flops, launches) -> dict:
    """One entry of the kernels line; the bound is the larger of the bytes
    (each input read once, each output written once) over the memory rate
    and the flops over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }


def full_width(dev: torch.device, card: str) -> tuple:
    import torch.nn.functional as F

    import cleora_tpu_torch as ctt
    from cleora_tpu_torch.ops.attention import (
        attention_spmm,
        attention_spmm_plain,
        edge_attention_weights,
        edge_attention_weights_plain,
    )
    from cleora_tpu_torch.ops.init import device_init, device_init_plain
    from cleora_tpu_torch.ops.loop import embed_loop
    from cleora_tpu_torch.ops.normalize import l2_normalize_plain, normalize
    from cleora_tpu_torch.ops.spmm import spmm, spmm_plain
    from cleora_tpu_torch.ops.whiten import whiten

    t0 = time.perf_counter()
    g = random_graph(FULL_NODES, FULL_UND_EDGES, seed=7)
    ingest_s = time.perf_counter() - t0
    n, nnz = g.num_entities, g.num_edges
    t0 = time.perf_counter()
    init = g.initialize_deterministically(DIM)
    init_s = time.perf_counter() - t0
    log(f"full width: {n} entities, {nnz} nnz; ingest {ingest_s:.3f} s, "
        f"host init {init_s:.3f} s")
    hub_census("phase 5's graph", g)

    # ---- the main path, through the user's entry point
    out, launches = run_main_path("embed()", lambda: ctt.embed(
        g, feature_dim=DIM, num_iterations=ITERATIONS, whiten=True))
    none = dict.fromkeys(launches, 0)
    assert launches == none | {  # K2 is fused into K1: no K2 launch
        "spmm_csr": ITERATIONS, "hash_init": 1}, launches
    check_covariance(out, dev)

    # ---- the attention path, through the user's entry point
    att_out, att_launches = run_main_path(
        "embed_with_attention()", lambda: ctt.embed_with_attention(
            g, feature_dim=DIM, num_iterations=ITERATIONS, whiten=True))
    # the first iteration is a propagate step (K1), each later one the
    # fused pass alone (then whitening)
    assert att_launches == none | {
        "spmm_csr": 1, "hash_init": 1,
        "attention_spmm": ITERATIONS - 1}, att_launches
    check_covariance(att_out, dev)
    del att_out

    # ---- rows wider than one tile keep K1 then K2, and K2 + K4 + K1 + K2
    # for attention (on phase 4's graph: the entry point a user with
    # D > 1024 calls)
    wide = random_graph(PARITY_NODES, PARITY_EDGES, seed=3)
    wide_out, wide_launches = run_main_path(
        f"embed_with_attention(D={WIDE_DIM}, {WIDE_ITERATIONS} iterations, "
        "phase 4's graph)", lambda: ctt.embed_with_attention(
            wide, feature_dim=WIDE_DIM, num_iterations=WIDE_ITERATIONS,
            whiten=False))
    assert wide_launches == none | {
        "spmm_csr": WIDE_ITERATIONS, "hash_init": 1,
        "row_normalize": 2 * WIDE_ITERATIONS - 1,
        "edge_attention": WIDE_ITERATIONS - 1}, wide_launches
    wide_rows, _ = wide_path(wide, wide_out, dev, card)
    del wide, wide_out

    # ---- K3 at full width: bitwise against the host init, and its time
    hashes = g._device_hashes(dev)
    k3_out = device_init(hashes, DIM)
    torch.cuda.synchronize()
    assert k3_out.cpu().numpy().tobytes() == init.tobytes()
    k3_plain = device_init_plain(hashes, DIM)
    assert torch.equal(k3_out, k3_plain)
    del k3_plain
    k3_ms = time_ms(lambda: device_init(hashes, DIM))
    k3_plain_ms = time_ms(lambda: device_init_plain(hashes, DIM), reps=3,
                          warmup=1)
    log(f"K3 {k3_ms:.3f} ms on the card (plain {k3_plain_ms:.3f} ms), "
        f"bitwise equal to the host init, which took {init_s:.3f} s; [{card}]")

    # ---- the loop alone, on the cached device CSR
    csr = g._device_csr("left", dev)
    x0 = k3_out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embed_loop(csr, x0, ITERATIONS, 0.0, "l2", True)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    log(f"loop: {loop_s:.3f} s for {ITERATIONS} iterations, "
        f"{nnz * ITERATIONS / loop_s:.4e} edge-ops/s")

    # ---- per-iteration split by CUDA events over a few iterations: K1
    # with the l2 normalisation fused (the loop's step), against the
    # two-pass design (K1 without it, then K2) in the same run
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
          for _ in range(3)]
    x = x0
    for e in ev:
        e[0].record()
        y2 = normalize(spmm(csr, x), "l2")
        e[1].record()
        del y2
        e[2].record()
        y = spmm(csr, x, normalization="l2")
        e[3].record()
        x = whiten(y)
        e[4].record()
    torch.cuda.synchronize()
    split = [np.mean([e[k].elapsed_time(e[k + 1]) for e in ev])
             for k in range(4)]
    log(f"per iteration: K1 with the l2 normalisation fused "
        f"{split[2]:.3f} ms against K1 then K2 {split[0]:.3f} ms; whiten "
        f"{split[3]:.3f} ms; [{card}]")
    # whitening's bound: its two N x D x D float32 GEMMs (covariance and
    # projection) against reading its input and writing its output once
    wh_ops_ms = 2 * 2 * n * DIM * DIM / FP32_FLOP_PER_S * 1e3
    wh_bytes_ms = 2 * 4 * n * DIM / HBM_BYTES_PER_S * 1e3
    log(f"whiten bound {max(wh_ops_ms, wh_bytes_ms):.3f} ms (operations "
        f"{wh_ops_ms:.3f} ms, bytes {wh_bytes_ms:.3f} ms)")
    device_share(csr, x0)

    # ---- an attention iteration: the fused pass (then whitening) against
    # the five passes it replaces (a float32 copy of x, K2 on it, K4, K1
    # with K4's weights, K2), in the same run
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(8)]
          for _ in range(3)]
    for e in ev:
        e[0].record()
        xn = normalize(x.to(torch.float32, copy=True), "l2")
        e[1].record()
        weights = edge_attention_weights(csr, xn, 1.0)
        e[2].record()
        y5 = spmm(csr.with_vals(weights), x)
        e[3].record()
        y5 = normalize(y5, "l2")
        e[4].record()
        del xn, weights, y5
        e[5].record()
        y = attention_spmm(csr, x, 1.0, "l2")
        e[6].record()
        x = whiten(y)
        e[7].record()
    torch.cuda.synchronize()
    split = [np.mean([e[k].elapsed_time(e[k + 1]) for e in ev])
             for k in range(7)]
    log(f"per attention iteration: the fused pass {split[5]:.3f} ms against "
        f"the five passes {sum(split[:4]):.3f} ms (copy + K2 "
        f"{split[0]:.3f}, K4 {split[1]:.3f}, K1 {split[2]:.3f}, K2 "
        f"{split[3]:.3f}); whiten {split[6]:.3f} ms; [{card}]")
    del x, y

    # ---- each kernel at the main path's shape: error, times, bounds.  K1
    # as the loop runs it (the l2 normalisation fused), against spmm_plain
    # + the plain normalisation; no single library call also normalises
    k1_out = spmm(csr, x0, normalization="l2")
    k1_plain = l2_normalize_plain(spmm_plain(csr, x0))
    torch.cuda.synchronize()
    k1_err = max_err(k1_out, k1_plain)
    torch.testing.assert_close(k1_out, k1_plain, rtol=1e-5, atol=1e-6)
    del k1_out, k1_plain
    k1_ms = time_ms(lambda: spmm(csr, x0, normalization="l2"))
    k1_plain_ms = time_ms(lambda: l2_normalize_plain(spmm_plain(csr, x0)),
                          reps=3, warmup=1)
    # K1 without the normalisation, against torch.sparse.mm
    k1n_out = spmm(csr, x0)
    k1n_plain = spmm_plain(csr, x0)
    torch.cuda.synchronize()
    k1n_err = max_err(k1n_out, k1n_plain)
    torch.testing.assert_close(k1n_out, k1n_plain, rtol=1e-5, atol=1e-6)
    k1n_ms = time_ms(lambda: spmm(csr, x0))
    k1n_plain_ms = time_ms(lambda: spmm_plain(csr, x0), reps=3, warmup=1)
    a = sparse_csr(csr)
    lib = torch.sparse.mm(a, x0)
    torch.testing.assert_close(lib, k1n_plain, rtol=1e-5, atol=1e-6)
    k1_lib_ms = time_ms(lambda: torch.sparse.mm(a, x0))
    del a, lib, k1n_plain

    y = k1n_out
    k2_out = normalize(y.clone(), "l2")
    k2_plain = l2_normalize_plain(y.clone())
    torch.cuda.synchronize()
    k2_err = max_err(k2_out, k2_plain)
    torch.testing.assert_close(k2_out, k2_plain, rtol=0.0, atol=1e-6)
    k2_ms = time_ms(lambda: normalize(k2_out, "l2"))
    k2_plain_ms = time_ms(lambda: l2_normalize_plain(k2_plain))
    k2_lib_ms = time_ms(lambda: F.normalize(y, p=2.0, dim=1, eps=1e-10))
    del k2_plain

    # K4 on the normalised state of one propagate step (T = 1, the default)
    xn = k2_out
    k4_out = edge_attention_weights(csr, xn, 1.0)
    k4_plain = edge_attention_weights_plain(csr, xn, 1.0)
    torch.cuda.synchronize()
    k4_err = max_err(k4_out, k4_plain)
    torch.testing.assert_close(k4_out, k4_plain, rtol=1e-5, atol=1e-6)
    del k4_plain
    k4_ms = time_ms(lambda: edge_attention_weights(csr, xn, 1.0))
    k4_plain_ms = time_ms(lambda: edge_attention_weights_plain(csr, xn, 1.0),
                          reps=3, warmup=1)
    del k4_out

    # the fused attention pass on the same state, l2 (the main path's)
    att_got = attention_spmm(csr, xn, 1.0, "l2")
    att_want = attention_spmm_plain(csr, xn, 1.0, "l2")
    torch.cuda.synchronize()
    att_err = max_err(att_got, att_want)
    torch.testing.assert_close(att_got, att_want, rtol=1e-5, atol=1e-6)
    del att_got, att_want
    att_ms = time_ms(lambda: attention_spmm(csr, xn, 1.0, "l2"))
    att_plain_ms = time_ms(lambda: attention_spmm_plain(csr, xn, 1.0, "l2"),
                           reps=3, warmup=1)

    # bound: each input read once, each output written once, against the
    # flops at float32 — the larger of the two times
    k1_bytes = 8 * (n + 1) + 8 * nnz + 4 * n * DIM + 4 * n * DIM
    k1_flops = 2 * nnz * DIM + 3 * n * DIM
    # K3: the hashes in, the init out; one float division per value (its
    # integer work has no float32 peak to set it against)
    k3_bytes = 8 * n + 4 * n * DIM
    k3_flops = n * DIM
    # the fused pass: x, the CSR and y once; per edge a dot product, a
    # sum of squares and the weighted add
    att_bytes = k1_bytes
    att_flops = 6 * nnz * DIM + 6 * n * DIM
    gather_bytes = nnz * (8 + 4 * DIM) + 4 * n * DIM
    loop_bound_ms = ITERATIONS * (
        max(k1_bytes / HBM_BYTES_PER_S, k1_flops / FP32_FLOP_PER_S)
        + max(wh_ops_ms, wh_bytes_ms) * 1e-3) * 1e3
    log(f"loop bound: {ITERATIONS} x (K1 + whiten bounds) = "
        f"{loop_bound_ms:.3f} ms against {loop_s * 1e3:.3f} ms measured")
    log(f"K1 (l2 fused) {k1_ms:.3f} ms (plain {k1_plain_ms:.3f}); K1 "
        f"without it {k1n_ms:.3f} ms (plain {k1n_plain_ms:.3f}, "
        f"torch.sparse.mm {k1_lib_ms:.3f}, max |err| {k1n_err:.3e}); bound "
        f"{k1_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; one x row per edge = "
        f"{gather_bytes / 1e9:.3f} GB -> floor "
        f"{gather_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, "
        f"{gather_bytes / (k1_ms * 1e-3) / 1e12:.3f} TB/s; [{card}]")
    # K2 and K4 at D = 256 are off the main paths of this phase (the
    # kernels line takes them from the D = 1028 path, wide_path); K2's
    # kernel for up to 1,024 columns still runs after the spectral
    # siblings and halo="overlap"'s rounds
    log(f"K2 at D={DIM} {k2_ms:.3f} ms (plain {k2_plain_ms:.3f}, "
        f"F.normalize {k2_lib_ms:.3f}, max |err| {k2_err:.3e}); [{card}]")
    log(f"K4 at D={DIM} {k4_ms:.3f} ms (plain {k4_plain_ms:.3f}, max |err| "
        f"{k4_err:.3e}); one xn row per edge = {gather_bytes / 1e9:.3f} GB "
        f"-> {gather_bytes / (k4_ms * 1e-3) / 1e12:.3f} TB/s; [{card}]")
    log(f"fused attention pass (l2) {att_ms:.3f} ms (plain "
        f"{att_plain_ms:.3f}); bound {att_bytes / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms; one x row per edge floor "
        f"{gather_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; [{card}]")
    del xn, k2_out, y, k1n_out

    power_law_hubs(dev, card)

    return [
        kernel_row("spmm_csr", "cleora_tpu_torch/kernels/spmm_csr.cu",
                   "cleora_tpu/ops/spmm_ell.py:437", k1_ms, k1_plain_ms,
                   None, k1_err, k1_bytes, k1_flops, launches["spmm_csr"]),
        kernel_row("row_normalize",
                   "cleora_tpu_torch/kernels/row_normalize.cu",
                   "cleora_tpu/ops/normalize.py:15", *wide_rows["k2"],
                   wide_launches["row_normalize"]),
        # no single PyTorch call computes K3's, K4's or the fused pass's
        # function
        kernel_row("hash_init", "cleora_tpu_torch/kernels/hash_init.cu",
                   "cleora_tpu/ops/init.py:60", k3_ms, k3_plain_ms, None, 0.0,
                   k3_bytes, k3_flops, launches["hash_init"]),
        kernel_row("edge_attention",
                   "cleora_tpu_torch/kernels/edge_attention.cu",
                   "cleora_tpu/__init__.py:502", *wide_rows["k4"],
                   wide_launches["edge_attention"]),
        kernel_row("attention_spmm",
                   "cleora_tpu_torch/kernels/edge_attention.cu",
                   "cleora_tpu/__init__.py:502", att_ms, att_plain_ms, None,
                   att_err, att_bytes, att_flops,
                   att_launches["attention_spmm"]),
    ], g, out


def wide_path(wide, wide_out: np.ndarray, dev: torch.device,
              card: str) -> tuple:
    """The D = 1028 attention path (rows wider than one column tile: K1
    then K2, and K2 + K4 + K1 + K2 an attention iteration) held to its
    plain versions: the entry point's output against the plain chain
    from the same init (normalize_plain(spmm_plain) then
    attention_spmm_plain), and one attention step on the same state
    against attention_spmm_plain, both at rtol=1e-5, atol=1e-6; then K2
    and K4 at that shape against their plain versions and timed.
    Returns ({"k2": ..., "k4": ...} kernel_row arguments before the
    launches, the step's max |err|)."""
    import torch.nn.functional as F

    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.attention import (
        attention_spmm_plain,
        attention_step,
        edge_attention_weights,
        edge_attention_weights_plain,
    )
    from cleora_tpu_torch.ops.init import device_init_plain
    from cleora_tpu_torch.ops.normalize import (
        l2_normalize_plain,
        normalize,
        normalize_plain,
    )
    from cleora_tpu_torch.ops.spmm import spmm_plain

    csr = wide._device_csr("left", dev)
    n, nnz, d = csr.n_rows, csr.nnz, WIDE_DIM
    x = normalize_plain(spmm_plain(
        csr, device_init_plain(wide._device_hashes(dev), d)), "l2")
    state = x
    for _ in range(WIDE_ITERATIONS - 1):
        x = attention_spmm_plain(csr, x, 1.0, "l2")
    got = torch.from_numpy(wide_out).to(dev)
    run_err = max_err(got, x)
    torch.testing.assert_close(got, x, rtol=1e-5, atol=1e-6)
    del got, x
    kernels.reset_launches()
    y = attention_step(csr, state, 1.0, "l2")
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert launches == {"row_normalize": 2, "edge_attention": 1,
                        "spmm_csr": 1}, launches
    want = attention_spmm_plain(csr, state, 1.0, "l2")
    torch.cuda.synchronize()
    step_err = max_err(y, want)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
    del y, want

    # K2 on the wide state (one block a row), K4 on its l2-normalised copy
    raw = spmm_plain(csr, state)
    k2_out = normalize(raw.clone(), "l2")
    k2_plain = l2_normalize_plain(raw.clone())
    torch.cuda.synchronize()
    k2_err = max_err(k2_out, k2_plain)
    torch.testing.assert_close(k2_out, k2_plain, rtol=0.0, atol=1e-6)
    k2_ms = time_ms(lambda: normalize(k2_out, "l2"))
    k2_plain_ms = time_ms(lambda: l2_normalize_plain(k2_plain))
    k2_lib_ms = time_ms(lambda: F.normalize(raw, p=2.0, dim=1, eps=1e-10))
    del k2_plain, raw
    xn = k2_out
    k4_out = edge_attention_weights(csr, xn, 1.0)
    k4_plain = edge_attention_weights_plain(csr, xn, 1.0)
    torch.cuda.synchronize()
    k4_err = max_err(k4_out, k4_plain)
    torch.testing.assert_close(k4_out, k4_plain, rtol=1e-5, atol=1e-6)
    del k4_out, k4_plain
    k4_ms = time_ms(lambda: edge_attention_weights(csr, xn, 1.0))
    k4_plain_ms = time_ms(lambda: edge_attention_weights_plain(csr, xn, 1.0))
    # K2: x read and written once; K4: xn, the CSR and the weights once,
    # the scores' dot products
    k2_bytes, k2_flops = 2 * 4 * n * d, 3 * n * d
    k4_bytes = 4 * n * d + 8 * (n + 1) + 8 * nnz + 4 * nnz
    k4_flops = 2 * nnz * d
    log(f"  D={d} path on phase 4's graph ({n} rows, {nnz} entries): the "
        f"entry point's output against the plain chain max |err| "
        f"{run_err:.3e}; one attention step (K2, K4, K1, K2) against "
        f"attention_spmm_plain {step_err:.3e}; K2 {k2_ms:.4f} ms (plain "
        f"{k2_plain_ms:.4f}, F.normalize {k2_lib_ms:.4f}, max |err| "
        f"{k2_err:.3e}, bound {k2_bytes / HBM_BYTES_PER_S * 1e3:.4f}); K4 "
        f"{k4_ms:.4f} ms (plain {k4_plain_ms:.4f}, max |err| {k4_err:.3e}, "
        f"bound {k4_bytes / HBM_BYTES_PER_S * 1e3:.4f}); [{card}]")
    # no single PyTorch call computes K4's function
    return {"k2": (k2_ms, k2_plain_ms, k2_lib_ms, k2_err, k2_bytes,
                   k2_flops),
            "k4": (k4_ms, k4_plain_ms, None, k4_err, k4_bytes,
                   k4_flops)}, step_err


def hub_census(name: str, g) -> None:
    """The rows of a graph's CSR over kernels.LONG_SLICE entries (the rows
    that K1, the fused attention pass and K5 cut into slices) and the
    share of the entries they hold."""
    from cleora_tpu_torch import kernels

    deg = np.diff(g.data.indptr)
    over = deg > kernels.LONG_SLICE
    log(f"  hub census, {name}: largest row {int(deg.max())} entries; "
        f"{int(over.sum())} rows over {kernels.LONG_SLICE} entries, holding "
        f"{int(deg[over].sum())} of {int(deg.sum())} entries")


def sparse_csr(csr):
    """The library's CSR tensor of a CsrMatrix (torch.sparse.mm's operand)."""
    n = csr.n_rows
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(csr.indptr.int(), csr.indices,
                                       csr.vals, size=(n, n),
                                       check_invariants=False)


def chung_lu_csr(n: int, pairs: int, seed: int, dev: torch.device):
    """A left-Markov CSR drawn on the card by the Chung-Lu rule: ``pairs``
    pairs, each endpoint drawn with probability proportional to
    (i + 1)^-POWER_LAW_EXPONENT, both directions kept, duplicates kept
    (the SpMM sums them), values 1 / degree."""
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    gen = torch.Generator(device=dev).manual_seed(seed)
    weight = torch.arange(1, n + 1, device=dev,
                          dtype=torch.float64) ** -POWER_LAW_EXPONENT
    cdf = torch.cumsum(weight, 0)
    cdf /= cdf[-1].clone()
    ends = torch.searchsorted(cdf, torch.rand(
        (2, pairs), device=dev, generator=gen, dtype=torch.float64))
    ends.clamp_(max=n - 1)
    src = torch.cat([ends[0], ends[1]])
    dst = torch.cat([ends[1], ends[0]])
    del ends
    order = torch.argsort(src * n + dst)
    src, dst = src[order], dst[order]
    deg = torch.bincount(src, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg, 0, out=indptr[1:])
    vals = (1.0 / deg.clamp_min(1).float())[src]
    return CsrMatrix(indptr, dst.to(torch.int32), vals), deg


def power_law_hubs(dev: torch.device, card: str) -> None:
    """K1 and the fused attention pass on a power-law graph of phase 5's
    size (Chung-Lu, drawn on the card from seed 7): K1 with its hub
    slices, K1 with every row walked by its own warp (for comparison
    only), torch.sparse.mm, and the fused pass, each with its bound and
    its one-row-per-edge floor."""
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.attention import (
        attention_spmm,
        attention_spmm_plain,
    )
    from cleora_tpu_torch.ops.spmm import spmm, spmm_plain

    t0 = time.perf_counter()
    csr, deg = chung_lu_csr(FULL_NODES, FULL_UND_EDGES, 7, dev)
    hubs = csr.hub_plan()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n, nnz = csr.n_rows, csr.nnz
    long_rows = deg > kernels.LONG_SLICE
    log(f"power-law graph (Chung-Lu, exponent {POWER_LAW_EXPONENT}, seed 7, "
        f"drawn on the card in {build_s:.3f} s): {n} rows, {nnz} entries; "
        f"largest degree {int(deg.max())}; {int(long_rows.sum())} rows over "
        f"{kernels.LONG_SLICE} entries holding {int(deg[long_rows].sum())} "
        f"entries, cut into {hubs.item_rows.shape[0]} slices")
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((n, DIM), device=dev, generator=gen)
    x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    # rows up to LONG_SLICE entries against the plain version, the hubs
    # (up to 333,156 entries) against their float64 reference
    # (assert_rows_close); K1 with every row a warp, timed for comparison
    # only, sums a hub in one sequence and is held on the hubs to the
    # float32 bound of such a sum, (n - 1) 2^-24 sum |term| (Higham)
    hub_ids = torch.nonzero(long_rows).flatten()
    ref, mag = hub_rows_float64(csr, x, hub_ids)
    got = spmm(csr, x)
    want = spmm_plain(csr, x)
    unsliced = kernels.spmm_csr(csr.indptr, csr.indices, csr.vals, x)
    torch.cuda.synchronize()
    err = assert_rows_close(got, want, long_rows, ref)
    torch.testing.assert_close(unsliced[~long_rows], want[~long_rows],
                               rtol=1e-5, atol=1e-6)
    bound = (deg[hub_ids] - 1).double()[:, None] * 2.0**-24 * mag
    whole_err = (unsliced[hub_ids].double() - ref).abs()
    assert bool((whole_err <= bound).all()), float(whole_err.max())
    err += f"; every row a warp: hub rows {float(whole_err.max()):.3e}"
    del got, want, unsliced, ref, mag, bound, whole_err
    sliced_ms = time_ms(lambda: spmm(csr, x))
    whole_ms = time_ms(lambda: kernels.spmm_csr(
        csr.indptr, csr.indices, csr.vals, x))
    a = sparse_csr(csr)
    lib_ms = time_ms(lambda: torch.sparse.mm(a, x))
    del a
    att = attention_spmm(csr, x, 1.0, "none")
    att_want = attention_spmm_plain(csr, x, 1.0, "none")
    ref, _ = hub_rows_float64(csr, x, hub_ids, temperature=1.0)
    torch.cuda.synchronize()
    att_err = assert_rows_close(att, att_want, long_rows, ref)
    del att, att_want, ref
    att_ms = time_ms(lambda: attention_spmm(csr, x, 1.0, "l2"))
    att_whole_ms = time_ms(lambda: kernels.attention_spmm(
        csr.indptr, csr.indices, csr.vals, x, 1.0, "l2"))
    once = 8 * (n + 1) + 8 * nnz + 2 * 4 * n * DIM
    floor = nnz * (8 + 4 * DIM) + 4 * n * DIM
    log(f"  K1 on it: {sliced_ms:.3f} ms with its hub slices, {whole_ms:.3f} "
        f"ms with every row a warp, torch.sparse.mm {lib_ms:.3f} ms; the "
        f"fused attention pass (l2) {att_ms:.3f} ms with slices, "
        f"{att_whole_ms:.3f} ms without; bound "
        f"{once / HBM_BYTES_PER_S * 1e3:.3f} ms (each input once), floor "
        f"{floor / HBM_BYTES_PER_S * 1e3:.3f} ms (one x row per entry); "
        f"against plain: K1 {err}, the pass {att_err}; "
        f"[{card}]")


@contextlib.contextmanager
def stopwatch(*targets):
    """Wall seconds spent inside each ``(owner, name)`` function while the
    block runs (the device is synchronised around every call); yields the
    dict that collects them."""
    seconds = {}
    saved = []

    def timed(real, key):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    for owner, name in targets:
        real = getattr(owner, name)
        saved.append((owner, name, real))
        setattr(owner, name, timed(real, name))
    try:
        yield seconds
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)


@contextlib.contextmanager
def recorded(owner, name: str):
    """Collect what ``owner.name`` returns while the block runs (it still
    runs as it is); yields the list."""
    real, seen = getattr(owner, name), []

    def call(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
        return out

    setattr(owner, name, call)
    try:
        yield seen
    finally:
        setattr(owner, name, real)


def run_spectral(name: str, call, expected=None, keep=None) -> dict:
    """One spectral entry point as a main path, called as a user calls it
    (nothing wrapped, no synchronisation inside): launch counts asserted
    (kernels not named in ``expected`` must not launch; None leaves the
    assertion to the caller), output finite with unit rows (an all-zero
    row of the factorised matrix stays zero).  ``keep[name]`` receives the
    output when ``keep`` is given."""
    from cleora_tpu_torch import kernels

    out, launches = run_main_path(name, call)
    if expected is not None:
        want = dict.fromkeys(kernels.LAUNCHES, 0) | expected
        assert launches == want, (launches, want)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    norms = np.linalg.norm(out, axis=1)
    zero = norms < 1e-6
    assert np.all((np.abs(norms - 1.0) <= 1e-3) | zero), (norms.min(),
                                                          norms.max())
    assert zero.mean() <= 0.01, zero.mean()
    log(f"  {name}: output {out.shape}, unit rows ({int(zero.sum())} zero "
        "rows)")
    if keep is not None:
        keep[name] = out
    return launches


def stage_split(name: str, call, *targets) -> None:
    """A second run of ``call`` with ``targets`` under the stopwatch.  The
    forced synchronisations serialise host and device, so its total is not
    the entry point's time: run_spectral's is."""
    with stopwatch(*targets) as stages:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    log(f"  {name}: second run under the stopwatch {wall_s:.3f} s; seconds "
        "by stage " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))


def staged_spectral(name: str, call, expected, *targets, keep=None) -> dict:
    """One run of a spectral entry point with ``targets`` under the
    stopwatch: launch counts, peak memory and the end-to-end seconds of
    that run (the stopwatch's synchronisations included), and the seconds
    by stage (also left in ``keep["stages"]``)."""
    with stopwatch(*targets) as stages:
        launches = run_spectral(name, call, expected, keep)
    log(f"  {name}: seconds by stage " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    if keep is not None:
        keep["stages"] = stages
    return launches


def check_blocked_block(alg, graph, dev: torch.device, card: str) -> dict:
    """The kernels of the blocked NetMF and GraRep paths against their
    plain versions at the shapes and on the states those paths give them:
    the first row block of ``graph``, walked step by step as
    algorithms.py's block bodies walk it, each kernel call beside its plain
    version on the same input.  Returns the largest error of each kernel."""
    from cleora_tpu_torch.ops.spmm import (
        spmm,
        spmm_axpy,
        spmm_axpy_plain,
        spmm_plain,
    )

    rows, cols, vals, n = alg._coo_f32(graph)
    csr_pt, deg, vol = alg._pt_csr(rows, cols, vals, n, dev)
    defaults = inspect.signature(alg.embed_netmf).parameters
    window = defaults["window_size"].default
    neg = defaults["negative_samples"].default
    b, max_step = BLOCK_ROWS, GRAREP_STEPS
    deg_dev = torch.from_numpy(deg).to(dev)
    scale = np.float32(vol / (neg * window))
    s_col = (float(scale) / deg_dev)[:b].contiguous()
    errs = {"spmm_axpy": 0.0, "spmm_csr": 0.0, "log_clip": 0.0}
    tol = {"rtol": 1e-5, "atol": 1e-6}

    # NetMF's block: `window` K5 steps that sum the walk, then K7
    y = alg._one_hot_block(n, b, 0, dev)
    acc = torch.zeros_like(y)
    for _ in range(window):
        want_acc = acc.clone()
        want = spmm_axpy_plain(csr_pt, y, 1.0, acc=want_acc, d=1.0)
        got = spmm_axpy(csr_pt, y, 1.0, acc=acc, d=1.0)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol)
        torch.testing.assert_close(acc, want_acc, **tol)
        errs["spmm_axpy"] = max(errs["spmm_axpy"], max_err(got, want),
                                max_err(acc, want_acc))
        y = got
        del want, want_acc, got
    # K5 at this panel's shape (a NetMF walk step), with both bounds: x,
    # acc read and acc, out written once; or one gathered x row an entry
    acc_t = acc.clone()
    k5_ms = time_ms(lambda: spmm_axpy(csr_pt, y, 1.0, acc=acc_t, d=1.0))
    lib_op = sparse_csr(csr_pt)
    k5_lib_ms = time_ms(lambda: acc_t.add_(torch.sparse.mm(lib_op, y)))
    del acc_t, lib_op
    panel = 4 * n * b
    once = 8 * (n + 1) + 8 * csr_pt.nnz + 4 * panel
    gathered = once - panel + 4 * csr_pt.nnz * b
    log(f"  K5 at the blocked panel ({n}, {b}): {k5_ms:.3f} ms "
        f"(torch.sparse.mm + add_ {k5_lib_ms:.3f}); bounds "
        f"{once / HBM_BYTES_PER_S * 1e3:.3f} ms (each input once), "
        f"{gathered / HBM_BYTES_PER_S * 1e3:.3f} ms (one x row an entry); "
        f"[{card}]")
    errs["log_clip"] = check_log_clip(acc, deg_dev, s_col, 1.0, 0.0)
    del acc

    # GraRep's block: K1 per power, K7 on a copy of each
    y = alg._one_hot_block(n, b, 0, dev)
    for _ in range(max_step):
        want = spmm_plain(csr_pt, y)
        got = spmm(csr_pt, y)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol)
        errs["spmm_csr"] = max(errs["spmm_csr"], max_err(got, want))
        y = got
        del want, got
        errs["log_clip"] = max(errs["log_clip"],
                               check_log_clip(y, None, None, *grarep_mode()))
    # K1 at this panel's shape (a GraRep power), against torch.sparse.mm;
    # bounds as K5's above
    k1_plain_ms = timed_once(lambda: spmm_plain(csr_pt, y))[1]
    k1_ms = time_ms(lambda: spmm(csr_pt, y))
    lib_op = sparse_csr(csr_pt)
    k1_lib_ms = time_ms(lambda: torch.sparse.mm(lib_op, y))
    del lib_op
    k1_once = 8 * (n + 1) + 8 * csr_pt.nnz + 2 * panel
    k1_gathered = k1_once - panel + 4 * csr_pt.nnz * b
    log(f"  K1 at the blocked panel ({n}, {b}): {k1_ms:.3f} ms (plain "
        f"{k1_plain_ms:.3f}, torch.sparse.mm {k1_lib_ms:.3f}); bounds "
        f"{k1_once / HBM_BYTES_PER_S * 1e3:.3f} ms (each input once), "
        f"{k1_gathered / HBM_BYTES_PER_S * 1e3:.3f} ms (one x row an "
        f"entry); [{card}]")
    errs["k1_panel"] = (k1_ms, k1_plain_ms, k1_lib_ms, errs["spmm_csr"],
                        k1_once, 2 * csr_pt.nnz * b)
    log(f"  one row block of the blocked paths, ({n}, {b}) on the "
        f"{csr_pt.nnz}-entry transposed transition CSR, each step against "
        f"its plain version: K5 ({window} NetMF walk steps) max |err| "
        f"{errs['spmm_axpy']:.3e}, K1 ({max_step} GraRep powers) "
        f"{errs['spmm_csr']:.3e}, K7 (NetMF's mode on the summed walk, "
        f"GraRep's on each power) {errs['log_clip']:.3e}")
    return errs


def spectral_full_width(dev: torch.device, card: str, g) -> tuple:
    """Phase 6: the five spectral siblings through their entry points, then
    K5, K6 and K7 at full size against their plain versions and timed.
    Returns the kernels' rows and what phase 12 compares with: RandNE's
    output, HOPE's sampled rows and its series length, the blocked graph
    with ProNE's sampled rows on it, and the dense graph."""
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch.ops import memory
    from cleora_tpu_torch.ops.dense import (
        dense_markov,
        dense_markov_plain,
        log_clip,
        log_clip_plain,
    )
    from cleora_tpu_torch.ops.spmm import (
        CsrMatrix,
        spmm_axpy,
        spmm_axpy_plain,
    )

    n, nnz = g.num_entities, g.num_edges
    log(f"phase 6, sparse siblings on {n} entities, {nnz} nnz")

    def randne():
        return alg.embed_randne(g, feature_dim=DIM, num_iterations=ITERATIONS,
                                backend="device")

    def hope():
        return alg.embed_hope(g, feature_dim=DIM, backend="device")

    # one run each, under the stopwatch: on the card its synchronisations
    # cost less than the spread between runs
    kept = {}
    staged_spectral("embed_randne()", randne, {"spmm_axpy": ITERATIONS},
                    (alg, "_device_weighted_sum_core"), (alg, "_fetch_f64"),
                    (alg, "_finalize"), keep=kept)
    sample = sample_rows(n)
    refs = {"randne": kept["embed_randne()"], "rows": sample}

    # HOPE's launch count follows from the series length its code derives:
    # 6 Katz applications (power_iters=2), each `terms` launches, read where
    # the code passes it on
    seen = {}
    real_katz = alg._katz

    def katz(csr, x, beta, terms):
        seen["terms"] = terms
        return real_katz(csr, x, beta, terms)

    alg._katz = katz
    try:
        hope_launches = staged_spectral(
            "embed_hope()", hope, None, (alg, "_katz"), (torch.linalg, "qr"),
            (torch.linalg, "svd"), (alg, "_fetch_f64"), (alg, "_finalize"),
            keep=kept)
    finally:
        alg._katz = real_katz
    refs["hope"] = kept.pop("embed_hope()")[sample]
    refs["hope_terms"] = seen["terms"]
    del kept
    log(f"  embed_hope(): k={DIM // 2}, r={DIM // 2 + 8}, "
        f"terms={seen['terms']}")
    assert seen["terms"] in (12, 13), seen
    assert hope_launches == dict.fromkeys(hope_launches, 0) | {
        "spmm_axpy": 6 * seen["terms"]}, hope_launches

    # ---- K5 at the sparse siblings' shape: error, times, bound
    rows, cols, vals, _, _ = g.to_sparse_csr()
    csr = CsrMatrix.from_coo(
        rows, cols, alg._sym_normalized_vals(rows, cols, vals, n), n, dev)
    del rows, cols, vals
    gen = torch.Generator(device=dev).manual_seed(6)
    x, z, acc = (torch.randn((n, DIM), device=dev, generator=gen)
                 for _ in range(3))
    k5_err = 0.0
    for case in K5_CASES:
        got, want = k5_pair(csr, x, z, acc, case)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            k5_err = max(k5_err, max_err(a, b))
        del got, want, a, b
    ca, cb, cc, cd = K5_CASES["chebyshev"][:4]
    k5_ms = time_ms(lambda: spmm_axpy(csr, x, ca, cb, z=z, c=cc, acc=acc,
                                      d=cd))
    k5_plain_ms = time_ms(lambda: spmm_axpy_plain(csr, x, ca, cb, z=z, c=cc,
                                                  acc=acc, d=cd),
                          reps=3, warmup=1)
    k5_randne_ms = time_ms(lambda: spmm_axpy(csr, x, 1.0, acc=acc, d=0.25))
    k5_bare_ms = time_ms(lambda: spmm_axpy(csr, x, -1.0, 1.0))
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a_lib = torch.sparse_csr_tensor(csr.indptr.int(), csr.indices,
                                        csr.vals, size=(n, n),
                                        check_invariants=False)

        def k5_library():
            out = torch.sparse.mm(a_lib, x).mul_(ca)
            out.add_(x, alpha=cb).add_(z, alpha=cc)
            acc.add_(out, alpha=cd)
            return out

        k5_lib_ms = time_ms(k5_library)
    x136, acc136 = (torch.randn((n, 136), device=dev, generator=gen)
                    for _ in range(2))
    got, want = k5_pair(csr, x136, None, acc136, "katz")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        k5_err = max(k5_err, max_err(a, b))
    del got, want, a, b
    k5_katz_ms = time_ms(lambda: spmm_axpy(csr, x136, 0.1, acc=acc136, d=1.0))
    del a_lib, x136, acc136
    # x, z and out move once, acc is read and written
    k5_bytes = 8 * (n + 1) + 8 * nnz + 3 * 4 * n * DIM + 8 * n * DIM
    k5_flops = 2 * nnz * DIM + 7 * n * DIM
    # one gathered x row an entry in place of each state row once
    k5_gathered = k5_bytes - 4 * n * DIM + 4 * nnz * DIM
    log(f"K5 D={DIM}: Chebyshev step (z, acc) {k5_ms:.3f} ms (plain "
        f"{k5_plain_ms:.3f}, torch.sparse.mm + 4 elementwise calls "
        f"{k5_lib_ms:.3f}); RandNE step (acc) {k5_randne_ms:.3f} ms; "
        f"x - N x alone {k5_bare_ms:.3f} ms; Katz step at D=136 "
        f"{k5_katz_ms:.3f} ms; max |err| {k5_err:.3e}; bounds of the "
        f"Chebyshev step {k5_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (each "
        f"input once), {k5_gathered / HBM_BYTES_PER_S * 1e3:.3f} ms (one x "
        f"row an entry); [{card}]")
    del csr, x, z, acc
    torch.cuda.empty_cache()

    # ---- the dense two
    t0 = time.perf_counter()
    gd = random_graph(DENSE_NODES, DENSE_UND_EDGES, seed=11, cover=True)
    nd, nnzd = gd.num_entities, gd.num_edges
    assert nd == DENSE_NODES
    log(f"phase 6, dense siblings on {nd} entities, {nnzd} nnz (ingest "
        f"{time.perf_counter() - t0:.3f} s); six (n, n) float32 buffers = "
        f"{6 * 4 * nd * nd / 1e9:.1f} GB")
    hub_census("phase 6's dense graph", gd)
    limit = memory.device_memory_limit(dev)
    gate_rows = int(np.sqrt(0.9 * limit / (6 * 4)))
    assert alg._dense_fits(gate_rows, device=dev)
    assert not alg._dense_fits(int(gate_rows * 1.01) + 1, device=dev)
    log(f"  dense gate on this card: {limit / 2**30:.3f} GiB free -> the "
        f"dense path takes n <= {gate_rows}; past it block_rows is "
        f"{alg._auto_block_rows(BLOCKED_NODES, DIM + 10, device=dev)} at "
        f"n={BLOCKED_NODES}; [{card}]")
    dense_targets = ((alg, "dense_markov"), (torch, "matmul"),
                     (alg, "log_clip"), (torch.linalg, "qr"),
                     (torch.linalg, "svd"), (alg, "_fetch_f64"))

    def netmf_dense():
        return alg.embed_netmf(gd, feature_dim=DIM, backend="device")

    def grarep_dense():
        return alg.embed_grarep(gd, feature_dim=DIM, max_step=GRAREP_STEPS,
                                backend="device")

    netmf = run_spectral("embed_netmf() dense", netmf_dense,
                         {"dense_markov": 1, "log_clip": 1})
    stage_split("embed_netmf() dense", netmf_dense, *dense_targets)
    run_spectral("embed_grarep() dense", grarep_dense,
                 {"dense_markov": 1, "log_clip": GRAREP_STEPS})
    stage_split("embed_grarep() dense", grarep_dense, *dense_targets)

    # ---- K6 and K7 at the dense siblings' shape
    rows, cols, vals, _ = alg._coo_f32(gd)
    csrd = CsrMatrix.from_coo(rows, cols, vals, nd, dev)
    k6_err = check_dense_markov(csrd)
    k6_ms = time_ms(lambda: dense_markov(csrd))
    k6_plain_ms = time_ms(lambda: dense_markov_plain(csrd), reps=3, warmup=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a_lib = torch.sparse_csr_tensor(csrd.indptr.int(), csrd.indices,
                                        csrd.vals, size=(nd, nd),
                                        check_invariants=False)

        def k6_library():
            p = a_lib.to_dense()
            return p.div_(p.sum(dim=1).clamp_min_(1e-10)[:, None])

        torch.testing.assert_close(k6_library(), dense_markov(csrd)[0],
                                   rtol=0.0, atol=1e-6)
        k6_lib_ms = time_ms(k6_library)
    del a_lib
    k6_bytes = 8 * (nd + 1) + 8 * nnzd + 4 * nd * nd + 4 * nd + 8
    k6_flops = 2 * nnzd
    log(f"K6 n={nd}: {k6_ms:.3f} ms (plain {k6_plain_ms:.3f}, to_dense + row "
        f"divide {k6_lib_ms:.3f}); max |err| {k6_err:.3e}; [{card}]")

    p, deg, vol = dense_markov(csrd)
    xk7 = torch.matmul(p, p)  # a transition power, as the entry points clip
    row_scale = (vol.float() / 5.0) / deg
    k7_err = max(
        check_log_clip(xk7, row_scale, deg, 1.0, 0.0),
        check_log_clip(xk7, None, None, *grarep_mode()))
    del p
    k7_ms = time_ms(lambda: log_clip(xk7, row_scale, deg, 1.0, 0.0))
    k7_grarep_ms = time_ms(lambda: log_clip(xk7, None, None, *grarep_mode()))
    k7_plain_ms = time_ms(
        lambda: log_clip_plain(xk7, row_scale, deg, 1.0, 0.0))
    k7_lib_ms = time_ms(lambda: torch.log(torch.clamp_min(
        xk7 * row_scale[:, None] * deg[None, :], 1.0)))
    k7_bytes = 2 * 4 * nd * nd + 4 * 2 * nd
    k7_flops = 5 * nd * nd
    log(f"K7 ({nd}, {nd}): NetMF mode {k7_ms:.3f} ms (plain "
        f"{k7_plain_ms:.3f}, torch.log(clamp_min(x*r*c)) {k7_lib_ms:.3f}); "
        f"GraRep mode {k7_grarep_ms:.3f} ms; max |err| {k7_err:.3e}; "
        f"[{card}]")
    del xk7, csrd
    refs["dense"] = gd
    torch.cuda.empty_cache()

    # ---- the blocked paths
    t0 = time.perf_counter()
    gb = random_graph(BLOCKED_NODES, BLOCKED_UND_EDGES, seed=12, cover=True)
    nb = gb.num_entities
    blocks = -(-nb // BLOCK_ROWS)
    sweeps = 2 + 2 * 1  # power_iters=1
    log(f"phase 6, blocked paths on {nb} entities, {gb.num_edges} nnz "
        f"(ingest {time.perf_counter() - t0:.3f} s): block_rows={BLOCK_ROWS},"
        f" {blocks} blocks, {sweeps} sweeps")
    hub_census("phase 6's blocked graph", gb)
    blocked_targets = ((alg, "spmm_axpy"), (alg, "spmm"), (alg, "log_clip"),
                       (torch, "matmul"), (torch.linalg, "qr"),
                       (torch.linalg, "svd"), (alg, "_fetch_f64"))
    kept = {}

    # ProNE here, not on phase 5's graph: its float64 host SVD of the
    # 1.96 M x 256 result took 45-68 s there on the H100's host (a cut
    # that keeps the time limit; phase 12 runs ProNE at full width with
    # the device epilogue)
    def prone():
        return alg.embed_prone(gb, feature_dim=DIM, backend="device")

    prone_launches = staged_spectral(
        "embed_prone()", prone, {"spmm_axpy": 9},
        (alg, "_prone_chebyshev_core"), (alg, "_fetch_f64"),
        (alg, "_svd_sqrt"), (alg, "_finalize"), keep=kept)

    def netmf_blocked():
        return alg.embed_netmf(gb, feature_dim=DIM, backend="device",
                               block_rows=BLOCK_ROWS, power_iters=1)

    def grarep_blocked():
        return alg.embed_grarep(gb, feature_dim=DIM, max_step=GRAREP_STEPS,
                                backend="device", block_rows=BLOCK_ROWS,
                                power_iters=1)

    blocked_errs = check_blocked_block(alg, gb, dev, card)
    torch.cuda.empty_cache()
    run_spectral("embed_netmf() blocked", netmf_blocked,
                 {"spmm_axpy": blocks * sweeps * 5,
                  "log_clip": blocks * sweeps})
    stage_split("embed_netmf() blocked", netmf_blocked, *blocked_targets)
    grarep_launches = run_spectral(
        "embed_grarep() blocked", grarep_blocked,
        {"spmm_csr": blocks * sweeps * GRAREP_STEPS,
         "log_clip": blocks * sweeps * GRAREP_STEPS})
    stage_split("embed_grarep() blocked", grarep_blocked, *blocked_targets)
    refs["blocked"] = gb
    refs["blocked_rows"] = sample_rows(nb)
    refs["blocked_prone"] = kept.pop("embed_prone()")[refs["blocked_rows"]]
    k5_err = max(k5_err, blocked_errs["spmm_axpy"])
    k7_err = max(k7_err, blocked_errs["log_clip"])

    src = "cleora_tpu_torch/kernels/"
    return [
        kernel_row("spmm_axpy", src + "spmm_axpy.cu",
                   "cleora_tpu/algorithms.py:186", k5_ms, k5_plain_ms,
                   k5_lib_ms, k5_err, k5_bytes, k5_flops,
                   prone_launches["spmm_axpy"]),
        kernel_row("dense_markov", src + "dense_markov.cu",
                   "cleora_tpu/algorithms.py:397", k6_ms, k6_plain_ms,
                   k6_lib_ms, k6_err, k6_bytes, k6_flops,
                   netmf["dense_markov"]),
        kernel_row("log_clip", src + "log_clip.cu",
                   "cleora_tpu/algorithms.py:429", k7_ms, k7_plain_ms,
                   k7_lib_ms, k7_err, k7_bytes, k7_flops, netmf["log_clip"]),
        kernel_row("spmm_csr_blocked", src + "spmm_csr.cu",
                   "cleora_tpu/algorithms.py:640", *blocked_errs["k1_panel"],
                   grarep_launches["spmm_csr"]),
    ], refs


# ------------------------------------------------------ phase 7: DeepWalk
def planted_edges(n, communities, deg_in, deg_out, rng):
    """scripts/walk_quality_probe.py's planted-partition generator (a copy:
    the script imports nothing of the JAX package)."""
    size = -(-n // communities)
    comm = np.arange(n) // size
    m_in = n * deg_in
    src_in = rng.integers(0, n, m_in)
    dst_in = np.minimum(
        comm[src_in] * size + rng.integers(0, size, m_in), n - 1)
    m_out = n * deg_out
    src_out = rng.integers(0, n, m_out)
    dst_out = rng.integers(0, n, m_out)
    return (np.concatenate([src_in, src_out]),
            np.concatenate([dst_in, dst_out]), comm)


def centroid_accuracy(emb, labels, rng, train_frac=0.5):
    """scripts/walk_quality_probe.py's nearest-centroid accuracy."""
    n = emb.shape[0]
    normed = emb / np.maximum(
        np.linalg.norm(emb, axis=1, keepdims=True), 1e-10)
    perm = rng.permutation(n)
    tr, te = perm[: int(n * train_frac)], perm[int(n * train_frac):]
    k = labels.max() + 1
    cents = np.zeros((k, emb.shape[1]), dtype=np.float64)
    for c in range(k):
        rows = tr[labels[tr] == c]
        if rows.size:
            cents[c] = normed[rows].mean(axis=0)
    cents /= np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-10)
    pred = np.argmax(normed[te] @ cents.T, axis=1)
    return float(np.mean(pred == labels[te]))


def partition(r, s: int):
    """Partition ``s``'s segment of a sweep reduce's (cen, ctx, cnt, m_per)."""
    start = sum(r[3][:s])
    end = start + r[3][s]
    return r[0][start:end], r[1][start:end], r[2][start:end], end - start


def walk_kernels_vs_plain(g, dev: torch.device, passes: int, label: str):
    """K8, K9 and K10 against their plain versions on ``g``'s first walk
    batch at the main path's batch size (K10 after the sweep and after a
    merge of the batch's two halves' partition 0).  Returns the tensors
    the timings reuse."""
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch.ops import cooccur
    from cleora_tpu_torch.ops.walk import (
        WalkTables,
        walk_uniform,
        walk_uniform_plain,
    )

    indptr, cols, deg, n = alg._walk_csr(g)
    tables = WalkTables(indptr, cols, deg, n, dev)
    starts = np.tile(np.nonzero(deg > 0)[0].astype(np.int32), WALKS_PER_NODE)
    starts = torch.from_numpy(starts[:alg._WALK_BATCH // 2]).to(dev)
    b = starts.shape[0]
    args = (tables.indptr, tables.cols, tables.deg, starts, WALK_LENGTH, 0, 0,
            n)
    walks = walk_uniform(*args)
    assert torch.equal(walks, walk_uniform_plain(*args))
    keys = cooccur.pair_keys(walks, b, n, WINDOW, passes)
    assert torch.equal(keys, cooccur.pair_keys_plain(walks, b, n, WINDOW,
                                                     passes))
    sorted_keys = torch.sort(keys).values
    del keys
    got = cooccur.run_length(sorted_keys, n, passes)
    want = cooccur.run_length_plain(sorted_keys, None, n, passes)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    del want
    h = b // 2
    halves = [cooccur._reduce_sweep(walks[lo:hi], 0, n, WINDOW, passes)
              for lo, hi in ((0, h), (h, b))]
    a0, b0 = (partition(r, 0) for r in halves)
    merged = cooccur._merge(a0, b0, n)
    plain = cooccur.merge_plain(a0, b0, n)
    assert all(torch.equal(x, y) for x, y in zip(merged[:3], plain[:3]))
    torch.cuda.synchronize()
    log(f"{label}: K8 walks ({b}, {WALK_LENGTH}), K9 keys "
        f"({sorted_keys.shape[0]}), K10 runs ({got[0].shape[0]}, {passes} "
        f"partitions) and K10 after a merge ({a0[3]} + {b0[3]} -> "
        f"{merged[3]} runs) bitwise equal to their plain versions")
    return tables, args, walks, sorted_keys, got


def ppmi_vs_plain(ranges, n: int, dev: torch.device, label: str):
    """K11's two passes against their plain versions on every range;
    returns the column sums, the total and the largest absolute error."""
    from cleora_tpu_torch.ops import cooccur

    zeros = lambda: (torch.zeros(n, dtype=torch.int64, device=dev),
                     torch.zeros(1, dtype=torch.int64, device=dev))
    col, total = zeros()
    col_p, total_p = zeros()
    for _, ctx, cnt, _ in ranges:
        cooccur.ppmi_colsum_(ctx, cnt, col, total)
        cooccur.ppmi_colsum_plain(ctx, cnt, col_p, total_p)
    torch.cuda.synchronize()
    assert torch.equal(col, col_p) and torch.equal(total, total_p)
    rel = err = 0.0
    for cen, ctx, cnt, _ in ranges:
        vals, indptr = cooccur.ppmi_values(cen, ctx, cnt, col, total, n)
        want, want_indptr = cooccur.ppmi_values_plain(cen, ctx, cnt, col,
                                                      total, n)
        torch.cuda.synchronize()
        assert torch.equal(indptr, want_indptr)
        torch.testing.assert_close(vals, want, rtol=1e-6, atol=0.0)
        err = max(err, max_err(vals, want))
        big = want != 0
        if bool(big.any()):
            rel = max(rel, float(((vals[big] - want[big]).abs()
                                  / want[big].abs()).max()))
        assert torch.equal(vals[~big], want[~big])
    log(f"{label}: K11 column sums and total bitwise, row pointers bitwise, "
        f"values max |err| {err:.3e}, max relative err {rel:.3e} over "
        f"{len(ranges)} ranges")
    return col, total, err


def k11_launch_only(cen, ctx, cnt, col, total, n: int):
    """K11's launch apart from its wrapper's checks and its host read of
    the flag (kernels.ppmi_into): the two passes over one range into
    buffers allocated once, the scratch (row sums and flag) zeroed before
    each launch, as the kernel requires."""
    from cleora_tpu_torch import kernels

    m = cen.shape[0]
    vals = torch.empty((m,), dtype=torch.float32, device=cen.device)
    indptr = torch.empty((n + 1,), dtype=torch.int64, device=cen.device)
    scratch = torch.zeros((n + 1,), dtype=torch.int64, device=cen.device)

    def run():
        scratch.zero_()
        kernels.ppmi_into(cen, ctx, cnt, col, total, n, vals, indptr,
                          scratch)

    return run


def ring_graph(n_nodes: int, n_und_edges: int, seed: int):
    """A ring through every node plus uniformly drawn edges, as a
    SparseMatrix: connected, so that no node sits in a small component.
    A small component's rows of the PPMI matrix lie outside the top-k
    singular subspace of the large one, so their factor rows are rounding
    noise that the finalize scales to unit length, on any backend: no
    comparison can hold them."""
    import cleora_tpu_torch as ctt

    rng = np.random.default_rng(seed)
    m = n_und_edges - n_nodes
    src = np.concatenate([np.arange(n_nodes), rng.integers(0, n_nodes, m)])
    dst = np.concatenate([(np.arange(n_nodes) + 1) % n_nodes,
                          rng.integers(0, n_nodes, m)])
    return ctt.SparseMatrix.from_edge_arrays(src, dst)


def walk_parity(dev: torch.device) -> None:
    """The card against device="cpu" on a connected 20,000-node graph:
    walks and counts bitwise, embeddings by their Gram matrix."""
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch.ops import cooccur

    g = ring_graph(PARITY_NODES, PARITY_EDGES, seed=3)
    n = g.num_entities
    cpu = torch.device("cpu")
    walk_kernels_vs_plain(g, dev, WALK_PARITY_PASSES, "phase 7 parity size")

    def walks(d):
        return np.concatenate(list(alg._device_walks(
            g, WALKS_PER_NODE, WALK_PARITY_LENGTH, 0, device=d)))

    wa, wb = walks(dev), walks(cpu)
    assert np.array_equal(wa, wb)

    def counts(d):
        return cooccur.device_pair_counts(
            lambda: alg._device_walks(g, WALKS_PER_NODE, WALK_PARITY_LENGTH,
                                      0, batch=alg._WALK_BATCH // 2,
                                      resident=True, device=d),
            n, WINDOW, passes=WALK_PARITY_PASSES, device=d)

    (ra, ma), (rb, mb) = counts(dev), counts(cpu)
    assert ma == mb and len(ra) == len(rb) == WALK_PARITY_PASSES
    for x, y in zip(ra, rb):
        assert x[3] == y[3] and all(torch.equal(p.cpu(), q)
                                    for p, q in zip(x[:3], y[:3]))
    log(f"phase 7 parity ({n} nodes, {wa.shape[0]} walks of "
        f"{WALK_PARITY_LENGTH}): walks bitwise equal on the card and the "
        f"CPU; {ma} unique pairs in {WALK_PARITY_PASSES} partitions, ranges "
        "bitwise equal")
    ppmi_vs_plain(ra, n, dev, "phase 7 parity size")
    del ra, rb

    rows = np.random.default_rng(0).choice(n, PARITY_SAMPLE, replace=False)
    base = dict(feature_dim=WALK_PARITY_DIM, num_walks=WALKS_PER_NODE,
                walk_length=WALK_PARITY_LENGTH, window_size=WINDOW,
                backend="device")
    for kw in (dict(cooccurrence="device"),
               dict(cooccurrence="host", factorization="device"),
               dict(cooccurrence="host", factorization="host")):
        a = alg.embed_deepwalk(g, device=dev, **base, **kw)
        b = alg.embed_deepwalk(g, device=cpu, **base, **kw)
        err, scale = gram_err(a, b, rows)
        log(f"parity embed_deepwalk({kw}) Gram ({PARITY_SAMPLE} rows): max "
            f"|err| {err:.3e} of max |G| {scale:.3e}")
        assert np.isfinite(a).all() and err <= 1e-3, err

    # Node2Vec: K12's walks bitwise equal to the plain version's on the
    # CPU, so every count is equal; the embeddings by their Gram matrix
    def walks2(d):
        return np.concatenate(list(alg._device_walks2(
            g, WALKS_PER_NODE, WALK_PARITY_LENGTH, N2V_P, N2V_Q, 0,
            device=d)))

    t0 = time.perf_counter()
    wa = walks2(dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wb = walks2(cpu)
    assert np.array_equal(wa, wb)
    log(f"phase 7 parity: {wa.shape[0]} Node2Vec walks (p={N2V_P}, "
        f"q={N2V_Q}) bitwise equal on the card ({card_s:.2f} s) and the CPU "
        f"({time.perf_counter() - t0:.2f} s)")
    n2v = dict(base, p=N2V_P, q=N2V_Q)
    for kw in (dict(cooccurrence="device"),
               dict(cooccurrence="host", factorization="device"),
               dict(cooccurrence="host", factorization="host")):
        a = alg.embed_node2vec(g, device=dev, **n2v, **kw)
        b = alg.embed_node2vec(g, device=cpu, **n2v, **kw)
        err, scale = gram_err(a, b, rows)
        log(f"parity embed_node2vec({kw}) Gram ({PARITY_SAMPLE} rows): max "
            f"|err| {err:.3e} of max |G| {scale:.3e}")
        assert np.isfinite(a).all() and err <= 1e-3, err


def walk_full_width(dev: torch.device, card: str) -> list:
    """Phase 7 at full width: embed_deepwalk through its entry point on
    scripts/deepwalk_e2e.py's corpus, its stages, K8-K11 at the main path's
    shapes, and the planted-partition quality check."""
    import cleora_tpu_torch.algorithms as alg
    import cleora_tpu_torch.ops.cooccur as cooccur
    import cleora_tpu_torch.ops.dense as dense
    import cleora_tpu_torch.ops.walk as walk

    t0 = time.perf_counter()
    g = random_graph(WALK_NODES, WALK_UND_EDGES, seed=7)
    ingest_s = time.perf_counter() - t0
    n = g.num_entities
    passes = alg._cooc_passes(g, WALKS_PER_NODE, WALK_LENGTH, WINDOW)
    deg = alg._walk_csr(g)[2]
    n_walks = int((deg > 0).sum()) * WALKS_PER_NODE
    batch = alg._WALK_BATCH // 2
    batches = -(-n_walks // batch)
    power_iters = inspect.signature(
        alg._device_counts_to_embeddings).parameters["power_iters"].default
    applies = 2 + 2 * power_iters
    log(f"phase 7, DeepWalk on {n} entities, {g.num_edges} nnz (ingest "
        f"{ingest_s:.3f} s): {n_walks} walks of {WALK_LENGTH} in {batches} "
        f"batches, window {WINDOW}, {passes} hash partitions, D={DIM}")
    hub_census("phase 7's graph", g)

    def deepwalk():
        return alg.embed_deepwalk(
            g, feature_dim=DIM, num_walks=WALKS_PER_NODE,
            walk_length=WALK_LENGTH, window_size=WINDOW, backend="device",
            cooccurrence="device")

    expected = {"walk_uniform": batches, "pair_enum": batches,
                "run_length": batches,
                "run_length_merge": (batches - 1) * passes,
                "ppmi": passes, "spmm_axpy": applies * passes}
    kept = {}
    launches = run_spectral("embed_deepwalk()", deepwalk, expected, kept)
    targets = ((walk, "walk_uniform"), (cooccur, "pair_keys"),
               (torch, "sort"), (cooccur, "run_length"),
               (cooccur, "ppmi_colsum_"), (cooccur, "ppmi_values"),
               (dense, "spmm_accumulate_"), (cooccur, "_merge"),
               (torch.linalg, "qr"),
               (torch.linalg, "svd"), (alg, "_finalize_factor"))
    staged_spectral("embed_deepwalk() stopwatch run", deepwalk, expected,
                    *targets)
    torch.cuda.empty_cache()

    # ---- the counts alone: pairs, unique pairs, K11 at full size
    def batches_fn():
        return alg._device_walks(g, WALKS_PER_NODE, WALK_LENGTH, 0,
                                 batch=batch, resident=True, device=dev)

    t0 = time.perf_counter()
    with captured_merges(cooccur, passes) as merges:
        ranges, m_total = cooccur.device_pair_counts(
            batches_fn, n, WINDOW, passes=passes, device=dev)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    pairs = cooccur.pair_total(ranges, n)
    log(f"  counting alone {count_s:.3f} s: {pairs} pairs -> {m_total} "
        f"unique ({m_total / JAX_UNIQUE_PAIRS - 1:+.4%} against the JAX "
        f"package's {JAX_UNIQUE_PAIRS} on this corpus shape); per partition "
        + ", ".join(str(r[3]) for r in ranges))
    assert abs(m_total / JAX_UNIQUE_PAIRS - 1) <= 0.01, m_total
    log_rsvd_bound(m_total, n, card)
    fingerprints = [range_fingerprint(r, n) for r in ranges]
    assert fingerprints == PHASE7_RANGES, fingerprints
    log("  the 8 count ranges' fingerprints (entries, pair sum, weighted key "
        "sum) equal those the sort-based merge gave on this corpus")
    # the count reductions (the overflow check's minimum, the pair sum)
    # and the column signs of the factor, timed alone
    cnt_min_ms = time_ms(lambda: [r[2].min() for r in ranges])
    cnt_sum_ms = time_ms(lambda: cooccur.pair_total(ranges, n))
    u = torch.randn((n, DIM), device=dev)
    sign_ms = time_ms(lambda: alg._column_signs(u))
    del u
    log(f"  count reductions over {m_total} int32 counts: the minimum "
        f"{cnt_min_ms:.3f} ms, the int64 pair sum {cnt_sum_ms:.3f} ms; the "
        f"column signs over ({n}, {DIM}) float32 {sign_ms:.3f} ms; [{card}]")
    col, total, k11_err = ppmi_vs_plain(ranges, n, dev, "phase 7 full size")
    cen, ctx, cnt, m0 = ranges[0]
    k11_wrapper_ms = time_ms(lambda: cooccur.ppmi_values(cen, ctx, cnt, col,
                                                         total, n))
    k11_ms = time_ms(k11_launch_only(cen, ctx, cnt, col, total, n))
    k11_plain_ms = time_ms(lambda: cooccur.ppmi_values_plain(
        cen, ctx, cnt, col, total, n), reps=3, warmup=1)
    k11_bytes = 12 * m0 + 8 * n + 8 + 4 * m0 + 8 * (n + 1)
    # the column sums of one range beside index_add_ (its int64 copies made
    # outside the timed calls)
    col2, tot2 = torch.zeros_like(col), torch.zeros_like(total)
    ctx64, cnt64 = ctx.long(), cnt.long()
    colsum_ms = time_ms(lambda: cooccur.ppmi_colsum_(ctx, cnt, col2, tot2))
    colsum_lib_ms = time_ms(lambda: col2.index_add_(0, ctx64, cnt64))
    colsum_bytes = 8 * m0 + 8 * n
    log(f"  K11 over range 0 ({m0} entries): the launch {k11_ms:.3f} ms, "
        f"the wrapper with its checks and one host read "
        f"{k11_wrapper_ms:.3f} ms (plain {k11_plain_ms:.3f}); bound "
        f"{k11_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes); its column "
        f"sums {colsum_ms:.3f} ms, index_add_ {colsum_lib_ms:.3f} ms, bound "
        f"{colsum_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes); [{card}]")
    del cen, ctx, cnt, col, total, col2, tot2, ctx64, cnt64
    merge_rows = [time_merge(cooccur, merges[k], n, k, card)
                  for k in ("first", "last")]
    del merges
    apply = time_rsvd_apply(cooccur.ppmi_csrs(ranges, n), n, dev, card)
    del ranges
    torch.cuda.empty_cache()

    # ---- K8-K10 at the main path's batch, against plain, and timed
    tables, args, walks, sorted_keys, runs = walk_kernels_vs_plain(
        g, dev, passes, "phase 7 full size")
    b = walks.shape[0]
    k8_ms = time_ms(lambda: walk.walk_uniform(*args))
    k8_plain_ms = time_ms(lambda: walk.walk_uniform_plain(*args), reps=3,
                          warmup=1)
    # each hop reads deg of its node and, when it moves, indptr and cols:
    # one 32-byte sector per random read; walks written, starts read once
    reads = int((walks[:, :-1] < n).sum())
    moves = int((walks[:, 1:] < n).sum())
    k8_bytes = 32 * (reads + 2 * moves) + 4 * b * WALK_LENGTH + 4 * b
    k9_ms = time_ms(lambda: cooccur.pair_keys(walks, b, n, WINDOW, passes))
    k9_plain_ms = time_ms(lambda: cooccur.pair_keys_plain(
        walks, b, n, WINDOW, passes), reps=3, warmup=1)
    lanes = sorted_keys.shape[0]
    k9_bytes = 4 * b * WALK_LENGTH + 8 * lanes
    keys = cooccur.pair_keys(walks, b, n, WINDOW, passes)
    sort_ms = time_ms(lambda: torch.sort(keys), reps=5)
    # keys read once, sorted keys and their int64 indices written once
    sort_bytes = 3 * 8 * keys.shape[0]
    log(f"torch.sort ({keys.shape[0]} int64 keys) {sort_ms:.3f} ms, bound "
        f"{sort_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes); [{card}]")
    del keys
    k10_ms = time_ms(lambda: cooccur.run_length(sorted_keys, n,
                                                passes))
    k10_plain_ms = time_ms(lambda: cooccur.run_length_plain(
        sorted_keys, None, n, passes), reps=3, warmup=1)
    k10_lib_ms = time_ms(lambda: torch.unique_consecutive(
        sorted_keys, return_counts=True))
    m = runs[0].shape[0]
    k10_bytes = 8 * lanes + 12 * m + 4 * passes
    first_batch = walks.cpu()
    log(f"K8 ({b} walks of {WALK_LENGTH}) {k8_ms:.3f} ms (plain "
        f"{k8_plain_ms:.3f}); K9 ({lanes} keys) {k9_ms:.3f} ms (plain "
        f"{k9_plain_ms:.3f}); torch.sort of the keys {sort_ms:.3f} ms; K10 "
        f"({m} runs) {k10_ms:.3f} ms (plain {k10_plain_ms:.3f}, "
        f"torch.unique_consecutive {k10_lib_ms:.3f}); K11 (range 0, {m0} "
        f"entries) {k11_ms:.3f} ms (plain {k11_plain_ms:.3f}); [{card}]")
    del tables, walks, sorted_keys, runs
    torch.cuda.empty_cache()

    # ---- quality: the planted partition of scripts/walk_quality_probe.py
    t0 = time.perf_counter()
    import cleora_tpu_torch as ctt

    src, dst, comm = planted_edges(QUALITY_NODES, QUALITY_COMMUNITIES,
                                   QUALITY_DEG_IN, QUALITY_DEG_OUT,
                                   np.random.default_rng(3))
    gq = ctt.SparseMatrix.from_edge_arrays(src, dst)
    labels = comm[np.array([int(e) for e in gq.entity_ids])]
    emb = alg.embed_deepwalk(gq, QUALITY_DIM, num_walks=WALKS_PER_NODE,
                             walk_length=QUALITY_WALK_LENGTH,
                             backend="device", cooccurrence="device")
    acc = centroid_accuracy(emb, labels, np.random.default_rng(1))
    log(f"quality: planted partition, {gq.num_entities} nodes, "
        f"{QUALITY_COMMUNITIES} communities, D={QUALITY_DIM}: centroid "
        f"accuracy {acc:.4f} ({time.perf_counter() - t0:.3f} s with ingest)")
    assert acc >= 0.99, acc

    src = "cleora_tpu_torch/kernels/"
    return [
        kernel_row("walk_uniform", src + "walk_uniform.cu",
                   "cleora_tpu/algorithms.py:1122", k8_ms, k8_plain_ms, None,
                   0.0, k8_bytes, 0, launches["walk_uniform"]),
        kernel_row("pair_enum", src + "pair_enum.cu",
                   "cleora_tpu/ops/cooccur.py:196", k9_ms, k9_plain_ms, None,
                   0.0, k9_bytes, 0, launches["pair_enum"]),
        kernel_row("run_length", src + "run_length.cu",
                   "cleora_tpu/ops/cooccur.py:46", k10_ms, k10_plain_ms,
                   k10_lib_ms, 0.0, k10_bytes, 0, launches["run_length"]),
        dict(kernel_row("ppmi", src + "ppmi.cu",
                        "cleora_tpu/ops/cooccur.py:939", k11_wrapper_ms,
                        k11_plain_ms, None, k11_err, k11_bytes, 0,
                        launches["ppmi"]), launch_ms=k11_ms),
        kernel_row("run_length_merge", src + "run_length.cu",
                   "cleora_tpu/ops/cooccur.py:339", merge_rows[-1]["ms"],
                   merge_rows[-1]["plain_ms"], None, 0.0,
                   merge_rows[-1]["bytes"], 0, launches["run_length_merge"]),
        kernel_row("spmm_axpy_long", src + "spmm_axpy.cu",
                   "cleora_tpu/algorithms.py:2142", apply["k5_ms"],
                   apply["k5_plain_ms"], apply["k5_lib_ms"], apply["k5_err"],
                   apply["k5_bytes"], 0, launches["spmm_axpy"]),
    ], g, {"emb": kept["embed_deepwalk()"], "walks": first_batch,
           "m_total": m_total, "ranges": fingerprints, "k8_ms": k8_ms}


@contextlib.contextmanager
def captured_merges(cooccur, passes: int):
    """Copies of the inputs of partition 0's first and last chain merge
    while the block counts (one sweep, no skipped partition: partition 0's
    merges are every ``passes``-th)."""
    real, seen, calls = cooccur._merge, {}, [0]

    def merge(a, b, n):
        if calls[0] % passes == 0:
            seen["last" if "first" in seen else "first"] = tuple(
                t.clone() for t in (*a[:3], *b[:3]))
        calls[0] += 1
        return real(a, b, n)

    cooccur._merge = merge
    try:
        yield seen
    finally:
        cooccur._merge = real


def time_merge(cooccur, inputs, n: int, label: str, card: str) -> dict:
    """K10's merge form on one captured chain merge: bitwise against its
    plain version, timed beside the sort that the path it replaces ran
    first (pack, torch.sort, gather; that path then reduced the sorted
    entries by the earlier K10, which scripts/torch_count_probe.py
    --parent times), with its bound (a and b read once at 12 bytes an
    entry, the output written once)."""
    a, b = inputs[:3], inputs[3:]
    got = cooccur._merge(a, b, n)
    want = cooccur.merge_plain(a, b, n)
    torch.cuda.synchronize()
    assert got[3] == want[3] and all(torch.equal(x, y) for x, y in
                                     zip(got[:3], want[:3]))

    def sort_path():
        keys = torch.cat([a[0].long() * n + a[1], b[0].long() * n + b[1]])
        keys, order = torch.sort(keys)
        return keys, torch.cat([a[2], b[2]])[order]

    row = {"ms": time_ms(lambda: cooccur._merge(a, b, n), reps=5),
           "sort_ms": time_ms(sort_path, reps=5),
           "plain_ms": time_ms(lambda: cooccur.merge_plain(a, b, n), reps=2,
                               warmup=1),
           "bytes": 12 * (a[0].shape[0] + b[0].shape[0] + got[3])}
    log(f"  K10 merge form, partition 0's {label} merge ({a[0].shape[0]} + "
        f"{b[0].shape[0]} -> {got[3]} entries): bitwise its plain version; "
        f"{row['ms']:.3f} ms (no torch.sort) against the sort path's "
        f"pack, torch.sort and gather alone {row['sort_ms']:.3f} ms, plain "
        f"{row['plain_ms']:.3f} ms; bound "
        f"{row['bytes'] / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes); [{card}]")
    return row


def time_rsvd_apply(pieces, n: int, dev: torch.device, card: str) -> dict:
    """The rsvd apply (ops/dense.py:_apply_pieces) over phase 7's PPMI
    pieces at width DIM + 16, and K5 over one piece: the long-row path
    (each piece's own rows, x in L2-sized bands) against the short-row
    path that served it before (K1 on the first piece and K5 over every row
    of the others) and K5's plain version, with both bounds (each input
    once; one gathered x row per entry)."""
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.algorithms import _device_counts_to_embeddings
    from cleora_tpu_torch.ops import dense
    from cleora_tpu_torch.ops.spmm import spmm, spmm_axpy, spmm_axpy_plain

    r = DIM + inspect.signature(_device_counts_to_embeddings).parameters[
        "oversample"].default
    x = torch.randn((n, r), device=dev)

    def short_rows():  # without a row plan K5 takes its short-row kernel
        y = spmm(pieces[0], x)
        for p in pieces[1:]:
            spmm_axpy(p, x, 1.0, acc=y, d=1.0)
        return y

    y = dense._apply_pieces(pieces, x)
    y_short = short_rows()
    torch.cuda.synchronize()
    apply_err = max_err(y, y_short)
    assert apply_err <= 1e-4 * max(1.0, float(y_short.abs().max())), apply_err
    del y, y_short
    apply_ms = time_ms(lambda: dense._apply_pieces(pieces, x), reps=3)
    short_ms = time_ms(short_rows, reps=3)
    nnz = sum(p.nnz for p in pieces)
    once = 8 * nnz + 8 * (n + 1) * len(pieces) + 2 * 4 * n * r
    gathered = 4 * r * nnz
    piece = pieces[1]
    acc = torch.randn((n, r), device=dev)
    want = acc.clone()
    dense.spmm_accumulate_(piece, x, acc)
    spmm_axpy_plain(piece, x, 1.0, acc=want, d=1.0)
    torch.cuda.synchronize()
    raw_err, raw_top = max_err(acc, want), float(want.abs().max())
    # K5's tolerance (rtol=1e-5, atol=1e-6: the row sum in another order)
    # holds on left-Markov rows, as in the card tests: the same piece with
    # each row's values divided by the row's sum.  The PPMI values
    # themselves sum 810 terms of either sign to ~1e2, where two float32
    # orders part by up to ~1e-3 (logged).
    counts = piece.indptr[1:] - piece.indptr[:-1]
    sums = torch.zeros(n, device=dev).index_add_(
        0, torch.repeat_interleave(torch.arange(n, device=dev), counts),
        piece.vals)
    markov = piece.with_vals(piece.vals / torch.repeat_interleave(
        sums.clamp_min(1e-30), counts))
    acc.copy_(want)
    dense.spmm_accumulate_(markov, x, acc)
    spmm_axpy_plain(markov, x, 1.0, acc=want, d=1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(acc, want, rtol=1e-5, atol=1e-6)
    k5_err = max_err(acc, want)
    del markov, sums, counts
    k5_ms = time_ms(lambda: dense.spmm_accumulate_(piece, x, acc))
    k5_plain_ms = time_ms(lambda: spmm_axpy_plain(piece, x, 1.0, acc=want,
                                                  d=1.0), reps=1, warmup=0)

    k5_short_ms = time_ms(lambda: spmm_axpy(piece, x, 1.0, acc=acc, d=1.0))
    sp = torch.sparse_csr_tensor(piece.indptr.int(), piece.indices,
                                 piece.vals, (n, n))
    k5_lib_ms = time_ms(lambda: acc.add_(torch.sparse.mm(sp, x)))
    del sp
    m = int(piece.row_plan().rows.shape[0])
    k5_once = 8 * piece.nnz + 8 * (n + 1) + 4 * m + 8 * m * r + 4 * n * r
    k5_gathered = 4 * r * piece.nnz + 8 * piece.nnz + 8 * m * r
    log(f"  rsvd apply over {len(pieces)} PPMI pieces ({nnz} entries, width "
        f"{r}): {apply_ms:.3f} ms by K5's long-row path against "
        f"{short_ms:.3f} ms by the short-row path (K1 + "
        f"{len(pieces) - 1} x K5 over every row), max |diff| "
        f"{apply_err:.3e}; bounds {once / HBM_BYTES_PER_S * 1e3:.3f} ms (each "
        f"input once), {gathered / HBM_BYTES_PER_S * 1e3:.3f} ms (one x row "
        f"from device memory per entry); [{card}]")
    log(f"  K5 over piece 1 ({m} non-empty rows of {n}, {piece.nnz} entries, "
        f"width {r}): long-row path {k5_ms:.3f} ms, short-row path "
        f"{k5_short_ms:.3f} ms, plain {k5_plain_ms:.3f} ms, "
        f"torch.sparse.mm + add_ {k5_lib_ms:.3f} ms; bounds "
        f"{k5_once / HBM_BYTES_PER_S * 1e3:.3f} ms (each input once), "
        f"{k5_gathered / HBM_BYTES_PER_S * 1e3:.3f} ms (one x row per "
        f"entry); against plain: max |diff| {k5_err:.3e} with the rows "
        f"left-Markov (rtol=1e-5, atol=1e-6), {raw_err:.3e} of max |entry| "
        f"{raw_top:.3e} on the PPMI values; [{card}]")
    time_hub_rows(piece, x, n, k5_ms, card)
    return {"k5_ms": k5_ms, "k5_plain_ms": k5_plain_ms,
            "k5_lib_ms": k5_lib_ms, "k5_err": k5_err, "k5_bytes": k5_once}


def time_hub_rows(piece, x: torch.Tensor, n: int, piece_ms: float,
                  card: str) -> None:
    """K5's long-row path on a skewed PPMI piece: phase 7's piece 1 with
    HUB_ROWS of its empty rows made hubs of HUB_ENTRIES random ascending
    columns each, every row left-Markov.  The row plan cuts each hub into
    about HUB_ENTRIES / kernels.LONG_SLICE slices, a warp each, that take
    the hub's chunks of 32 entries in turn; timed against a plan that cuts
    no row (a warp a hub), both held to the plain version."""
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops import dense
    from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm_axpy_plain

    dev = x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    lengths = piece.indptr[1:] - piece.indptr[:-1]
    empty = torch.nonzero(lengths == 0).flatten()
    hubs = empty[torch.randperm(empty.shape[0], generator=gen,
                                device=dev)[:HUB_ROWS]]
    key = torch.cat([
        torch.repeat_interleave(torch.arange(n, device=dev), lengths) * n
        + piece.indices.long(),
        hubs.repeat_interleave(HUB_ENTRIES) * n
        + torch.randint(0, n, (HUB_ROWS * HUB_ENTRIES,), generator=gen,
                        device=dev)])
    key, order = torch.sort(key)
    vals = torch.cat([piece.vals, torch.rand(HUB_ROWS * HUB_ENTRIES,
                                             generator=gen, device=dev)])
    vals = vals[order]
    del order
    rows = key // n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    sums = torch.zeros(n, device=dev).index_add_(0, rows, vals)
    vals /= sums.clamp_min(1e-30)[rows]
    cols = (key % n).to(torch.int32)
    del key, rows, sums
    want = torch.zeros((n, x.shape[1]), device=dev)
    spmm_axpy_plain(CsrMatrix(indptr, cols, vals), x, 1.0, acc=want, d=1.0)
    timed = {}
    for label, cut in (("cut", kernels.LONG_SLICE), ("whole", 1 << 62)):
        saved, kernels.LONG_SLICE = kernels.LONG_SLICE, cut
        try:
            skew = CsrMatrix(indptr, cols, vals)
            plan = skew.row_plan()  # built with this slice length
        finally:
            kernels.LONG_SLICE = saved
        acc = torch.zeros_like(want)
        dense.spmm_accumulate_(skew, x, acc)
        torch.cuda.synchronize()
        torch.testing.assert_close(acc, want, rtol=1e-5, atol=1e-6)
        err = max_err(acc, want)
        timed[label] = (time_ms(lambda: dense.spmm_accumulate_(skew, x, acc)),
                        int(plan.whole.shape[0] + plan.item_rows.shape[0]),
                        int(plan.split.shape[0]), err)
        del skew, plan, acc
    r = x.shape[1]
    nnz = cols.shape[0]
    gathered = 4 * r * nnz + 8 * nnz
    log(f"  K5 over piece 1 with {HUB_ROWS} hub rows of {HUB_ENTRIES} "
        f"entries ({nnz} entries, width {r}, left-Markov): hubs cut into "
        f"{-(-HUB_ENTRIES // kernels.LONG_SLICE)} slices each "
        f"({timed['cut'][1]} warps, {timed['cut'][2]} rows cut) "
        f"{timed['cut'][0]:.3f} ms, a warp a "
        f"row ({timed['whole'][1]} warps) {timed['whole'][0]:.3f} ms; "
        f"piece 1 without hubs {piece_ms:.3f} ms; max |diff| against plain "
        f"{timed['cut'][3]:.3e} / {timed['whole'][3]:.3e} (rtol=1e-5, "
        f"atol=1e-6); bound {gathered / HBM_BYTES_PER_S * 1e3:.3f} ms (one "
        f"x row per entry); [{card}]")


def range_fingerprint(r, n: int) -> tuple:
    """(entries, Σcnt, Σ(cen·n + ctx)·cnt wrapping in int64) of one count
    range: equal ranges give equal fingerprints."""
    cen, ctx, cnt, m = r
    key = cen.long() * n + ctx.long()
    return (int(m), int(cnt.sum(dtype=torch.int64)),
            int((key * cnt.long()).sum()))


def log_rsvd_bound(m_total: int, n: int, card: str) -> None:
    """The bound of one rsvd apply of ops/dense.py:rsvd_sparse over the
    PPMI CSR of ``m_total`` entries at width DIM + 16: its inputs read once
    (column ids and values, row pointers, x) and its output written once;
    and, beside it, the bytes of the gather that reads one row of x per
    entry."""
    from cleora_tpu_torch.algorithms import _device_counts_to_embeddings

    r = DIM + inspect.signature(_device_counts_to_embeddings).parameters[
        "oversample"].default
    once = 8 * m_total + 8 * (n + 1) + 2 * 4 * n * r
    gather = 4 * r * m_total
    log(f"  rsvd apply over {m_total} PPMI entries at width {r}: bound "
        f"{once / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes, each input once); "
        f"one x row per entry {gather / 1e9:.3f} GB -> "
        f"{gather / HBM_BYTES_PER_S * 1e3:.3f} ms at {HBM_BYTES_PER_S:.3g} "
        f"B/s; [{card}]")
    # the count reductions (pair sums, the minimum count) read the int32
    # counts once; the column signs read the (n, DIM) factor once
    log(f"  bounds of the count reductions, one pass over {m_total} int32 "
        f"counts: {4 * m_total / HBM_BYTES_PER_S * 1e3:.3f} ms; of the "
        f"column signs over ({n}, {DIM}) float32: "
        f"{4 * n * DIM / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes)")


# ------------------------------------------------------ phase 8: Node2Vec
def timed_once(fn) -> tuple:
    """``fn()`` once and its device time in ms, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


SECTOR_ENTRIES = 8  # 4-byte entries per 32-byte sector


def lower_bound_probes(cols: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, x: torch.Tensor) -> tuple:
    """K12's lower-bound search in ``cols[lo:hi]`` for ``x``, one lane per
    entry: the positions found, and the sector of ``cols`` each step
    probes (-1 for a lane that had stopped)."""
    lo, hi = lo.clone(), hi.clone()
    probes = []
    while True:
        active = lo < hi
        if not bool(active.any()):
            return lo, probes
        mid = lo + (hi - lo) // 2
        below = active & (cols[torch.where(active, mid, 0)] < x)
        probes.append(torch.where(active, mid // SECTOR_ENTRIES, -1))
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)


def distinct_sectors(sectors: list) -> torch.Tensor:
    """Per lane, the number of distinct non-negative sector ids among the
    columns of ``sectors``."""
    s = torch.stack(sectors, dim=1).sort(dim=1).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    return (new & (s >= 0)).sum(dim=1)


def k12_sector_bytes(walks: torch.Tensor, t, chunk: int = 16384) -> int:
    """The bytes K12's walks need, in 32-byte sectors: K12's reads replayed
    for the round each hop accepted (the rejected rounds are not visible in
    the output, so this is a floor), each distinct sector counted once per
    hop.  A hop from a live node reads deg of cur and, when its degree is
    positive, indptr, wmax and wsum (prev's indptr and deg are cur's of the
    hop before); the cols sectors that the backtrack search in cur's row,
    the proposal and the common-neighbour search in prev's row touch; the
    vals sectors of the backtrack edge and of the accepted proposal.  The
    walks are written and the starts read once."""
    n, entries = t.n, int(t.cols.shape[0])
    total = 4 * walks.numel() + 4 * walks.shape[0]
    for i in range(0, walks.shape[0], chunk):
        w = walks[i:i + chunk].long()
        cur, nxt = w[:, :-1].reshape(-1), w[:, 1:].reshape(-1)
        prev = torch.cat([torch.full_like(w[:, :1], n), w[:, :-2]],
                         dim=1).reshape(-1)
        live = cur < n
        cur, nxt, prev = cur[live], nxt[live], prev[live]
        d = t.deg[cur].long()
        total += 32 * int(live.sum())
        has = d > 0
        cur, nxt, prev, d = cur[has], nxt[has], prev[has], d[has]
        total += 3 * 32 * cur.shape[0]
        lo = t.indptr[cur].long()
        hi = lo + d
        first = prev >= n
        prev_c = torch.where(first, 0, prev)
        # the backtrack search in cur's row, then the test of its position
        bt_hi = torch.where(first, lo, hi)
        pos, cols_s = lower_bound_probes(t.cols, lo, bt_hi, prev)
        probe = (~first) & (pos < hi)
        cols_s.append(torch.where(probe, pos // SECTOR_ENTRIES, -1))
        found = probe & (t.cols[torch.where(probe, pos, 0)] == prev)
        vals_s = [torch.where(found, pos // SECTOR_ENTRIES, -1)]
        # the accepted proposal at its position in cur's row; after the
        # first hop its weight and the common-neighbour search in prev's row
        took = (nxt < n) & (first | (nxt != prev))
        e, _ = lower_bound_probes(t.cols, lo, torch.where(took, hi, lo), nxt)
        cols_s.append(torch.where(took, e // SECTOR_ENTRIES, -1))
        later = took & ~first
        vals_s.append(torch.where(later, e // SECTOR_ENTRIES, -1))
        plo = t.indptr[prev_c].long()
        phi = torch.where(later, plo + t.deg[prev_c].long(), plo)
        cpos, probes = lower_bound_probes(t.cols, plo, phi, nxt)
        cols_s += probes
        cols_s.append(torch.where(later & (cpos < phi),
                                  cpos // SECTOR_ENTRIES, -1))
        total += 32 * int(distinct_sectors(cols_s).sum()
                          + distinct_sectors(vals_s).sum())
    return total


def node2vec_full_width(dev: torch.device, card: str, g) -> tuple:
    """Phase 8: embed_node2vec through its entry point on phase 7's graph,
    its stages, K12 at the main path's batch against plain and timed, and
    the planted partition's quality.  Returns (kernel rows, the planted
    graph, its embedding)."""
    import cleora_tpu_torch as ctt
    import cleora_tpu_torch.algorithms as alg
    import cleora_tpu_torch.ops.cooccur as cooccur
    import cleora_tpu_torch.ops.dense as dense
    import cleora_tpu_torch.ops.walk as walk

    n = g.num_entities
    passes = alg._cooc_passes(g, N2V_WALKS, WALK_LENGTH, WINDOW)
    indptr, cols, deg, _, vals, wmax, wsum = alg._walk_csr(g, with_vals=True)
    n_walks = int((deg > 0).sum()) * N2V_WALKS
    batch = alg._WALK2_BATCH
    batches = -(-n_walks // batch)
    power_iters = inspect.signature(
        alg._device_counts_to_embeddings).parameters["power_iters"].default
    applies = 2 + 2 * power_iters
    tries = walk.walk2_tries(N2V_Q)
    log(f"phase 8, Node2Vec p={N2V_P} q={N2V_Q} (tries {tries}) on {n} "
        f"entities: {n_walks} walks of {WALK_LENGTH} in {batches} batches, "
        f"window {WINDOW}, {passes} hash partitions, D={DIM}")

    def node2vec():
        return alg.embed_node2vec(
            g, feature_dim=DIM, num_walks=N2V_WALKS, walk_length=WALK_LENGTH,
            window_size=WINDOW, p=N2V_P, q=N2V_Q, backend="device",
            cooccurrence="device", factorization="device")

    expected = {"walk_p_q": batches, "pair_enum": batches,
                "run_length": batches,
                "run_length_merge": (batches - 1) * passes,
                "ppmi": passes, "spmm_axpy": applies * passes}
    launches = run_spectral("embed_node2vec()", node2vec, expected)
    groups = {"K12 walks": ("walk_p_q",),
              "counting": ("pair_keys", "sort", "run_length", "_merge"),
              "PPMI": ("ppmi_colsum_", "ppmi_values"),
              "rsvd products": ("spmm_accumulate_",),
              "QR/SVD": ("qr", "svd"), "finalize": ("_finalize_factor",)}
    with stopwatch((walk, "walk_p_q"), (cooccur, "pair_keys"),
                   (torch, "sort"), (cooccur, "run_length"),
                   (cooccur, "ppmi_colsum_"), (cooccur, "ppmi_values"),
                   (dense, "spmm_accumulate_"), (cooccur, "_merge"),
                   (torch.linalg, "qr"), (torch.linalg, "svd"),
                   (alg, "_finalize_factor")) as stages:
        t0 = time.perf_counter()
        node2vec()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    split = {k: sum(stages.get(x, 0.0) for x in v) for k, v in groups.items()}
    split["other host"] = wall_s - sum(split.values())
    walk_s = stages["walk_p_q"]
    log(f"  embed_node2vec(): second run under the stopwatch {wall_s:.3f} s; "
        "seconds by stage " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in split.items())
        + f"; K12 {walk_s / batches * 1e3:.3f} ms per batch, "
        f"{n_walks * (WALK_LENGTH - 1) / walk_s:.4e} hops/s; [{card}]")
    torch.cuda.empty_cache()

    # ---- the counts alone: pairs and unique pairs
    def batches_fn():
        return alg._device_walks2(g, N2V_WALKS, WALK_LENGTH, N2V_P, N2V_Q, 0,
                                  resident=True, device=dev)

    t0 = time.perf_counter()
    ranges, m_total = cooccur.device_pair_counts(
        batches_fn, n, WINDOW, passes=passes, device=dev)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    pairs = cooccur.pair_total(ranges, n)
    log(f"  counting alone {count_s:.3f} s: {pairs} pairs -> {m_total} "
        f"unique ({m_total / JAX_N2V_UNIQUE_PAIRS - 1:+.4%} against the JAX "
        f"package's {JAX_N2V_UNIQUE_PAIRS} on this configuration)")
    assert pairs == N2V_PAIRS, pairs
    assert abs(m_total / JAX_N2V_UNIQUE_PAIRS - 1) <= 0.01, m_total
    log_rsvd_bound(m_total, n, card)
    del ranges
    torch.cuda.empty_cache()

    # ---- K12 at the main path's batch, against plain, and timed
    t = walk.WalkTables2(indptr, cols, deg, n, vals, wmax, wsum, dev)
    starts = np.tile(np.nonzero(deg > 0)[0].astype(np.int32), N2V_WALKS)
    starts = torch.from_numpy(starts[:batch]).to(dev)
    args = (t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum, starts,
            WALK_LENGTH, 1.0 / N2V_P, 1.0 / N2V_Q, tries, 0, 0, n)
    walks = walk.walk_p_q(*args)
    want, k12_plain_ms = timed_once(lambda: walk.walk_p_q_plain(*args))
    assert torch.equal(walks, want)
    k12_err = max_err(walks, want)
    del want
    k12_ms = time_ms(lambda: walk.walk_p_q(*args))
    k12_bytes = k12_sector_bytes(walks, t)
    first_batch = walks.cpu()
    log(f"K12 ({walks.shape[0]} walks of {WALK_LENGTH}) {k12_ms:.3f} ms "
        f"(plain {k12_plain_ms:.3f}), bitwise equal; "
        f"{walks.shape[0] * (WALK_LENGTH - 1) / (k12_ms * 1e-3):.4e} hops/s; "
        f"[{card}]")
    del t, walks, args
    torch.cuda.empty_cache()

    # ---- quality: the planted partition, biased walks
    t0 = time.perf_counter()
    src, dst, comm = planted_edges(QUALITY_NODES, QUALITY_COMMUNITIES,
                                   QUALITY_DEG_IN, QUALITY_DEG_OUT,
                                   np.random.default_rng(3))
    gq = ctt.SparseMatrix.from_edge_arrays(src, dst)
    labels = comm[np.array([int(e) for e in gq.entity_ids])]
    emb = alg.embed_node2vec(gq, QUALITY_DIM, num_walks=WALKS_PER_NODE,
                             walk_length=QUALITY_WALK_LENGTH, p=N2V_P,
                             q=N2V_Q, backend="device", cooccurrence="device")
    acc = centroid_accuracy(emb, labels, np.random.default_rng(1))
    log(f"quality: planted partition, Node2Vec p={N2V_P} q={N2V_Q}, "
        f"{gq.num_entities} nodes, {QUALITY_COMMUNITIES} communities, "
        f"D={QUALITY_DIM}: centroid accuracy {acc:.4f} "
        f"({time.perf_counter() - t0:.3f} s with ingest)")
    assert acc >= 0.99, acc

    row = kernel_row("walk_p_q", "cleora_tpu_torch/kernels/walk_p_q.cu",
                     "cleora_tpu/algorithms.py:1768", k12_ms, k12_plain_ms,
                     None, k12_err, k12_bytes, 0, launches["walk_p_q"])
    return [row], gq, emb, first_batch


# ----------------------------------------------------- phase 9: retrieval
# bfloat16 keeps 8 significant bits: rounding the query and a row moves
# their product by up to 2 * 2^-9 of its size, so a bfloat16 table cannot
# tell the query's row from one whose exact cosine is within 2^-7 of 1
BF16_COSINE_SLACK = 2.0 ** -7


def check_neighbours(name: str, got, qrows, held=None, table=None):
    """Each query's top-1 is the query's own row or ties it within 1e-6;
    then the first queries against ``held`` (the host brute force): the
    same indices except where scores tie within 1e-6, scores atol=1e-5.
    With ``table`` (a bfloat16 index) only the top-1 is checked: the
    query's own row, or a row whose exact float64 cosine with it is within
    BF16_COSINE_SLACK of 1."""
    others = []
    for res, row in zip(got, qrows):
        top = res[0]["index"]
        if top == row:
            continue
        if table is not None:
            a, b = (table[i].astype(np.float64) for i in (row, top))
            others.append(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert others[-1] >= 1.0 - BF16_COSINE_SLACK, (name, row, top)
        else:
            own = [r["similarity"] for r in res if r["index"] == row]
            assert own and res[0]["similarity"] - own[0] <= 1e-6, (name, row)
    if table is not None:
        log(f"  {name}: {len(qrows) - len(others)} of {len(qrows)} top-1 "
            f"are the query's row; the other top-1 rows' exact cosines with "
            f"it are >= {min(others, default=1.0):.6f}")
        return
    err = 0.0
    for res, want in zip(got, held):
        for rg, rw in zip(res, want):
            diff = abs(rg["similarity"] - rw["similarity"])
            err = max(err, diff)
            assert diff <= 1e-5, (name, rg, rw)
            if rg["index"] != rw["index"]:
                assert diff <= 1e-6, (name, rg, rw)
    log(f"  {name}: every top-1 is its query's row (or ties it); "
        f"{len(held)} queries against the host brute force: max |score "
        f"err| {err:.3e}")


def timed_query(name: str, call):
    """One warm call, then one timed call as a main path (launch counts
    zeroed before, read after); returns (result, launches)."""
    call()
    t0 = time.perf_counter()
    out, launches = run_main_path(name, call)
    log(f"  {name}: {(time.perf_counter() - t0) * 1e3:.3f} ms per batch")
    return out, launches


def encode_rows(table: np.ndarray, codebooks: np.ndarray,
                dev: torch.device) -> np.ndarray:
    """Every row's nearest centroid per subspace on the card
    (product_quantize's assignment rule), as uint8 codes."""
    from cleora_tpu_torch._util import full_float32_matmul

    m, c, sd = codebooks.shape
    codes = np.empty((table.shape[0], m), np.uint8)
    x = torch.from_numpy(table).to(dev)
    with full_float32_matmul():
        for i in range(m):
            sub = x[:, i * sd:(i + 1) * sd]
            cb = torch.from_numpy(codebooks[i]).to(dev)
            d2 = ((sub * sub).sum(1, keepdim=True) - 2 * sub @ cb.T
                  + (cb * cb).sum(1))
            codes[:, i] = torch.argmin(d2, dim=1).to(torch.uint8).cpu().numpy()
    return codes


def retrieval_full_width(dev: torch.device, card: str, g, table: np.ndarray,
                         gq, emb_q: np.ndarray) -> list:
    """Phase 9: exact cosine top-k (ANNIndex, ShardedDeviceIndex in both
    dtypes), PQ search with K13 and k-means over the full-width embedding;
    k-means card against CPU on the planted partition's embedding."""
    import torch.nn.functional as F

    import cleora_tpu_torch.community as community
    import cleora_tpu_torch.compress as compress
    import cleora_tpu_torch.search as search
    from cleora_tpu_torch._util import full_float32_matmul
    from cleora_tpu_torch.ops.pq import device_codes, pq_adc, pq_adc_plain

    n, d = table.shape
    rng = np.random.default_rng(9)
    qrows = rng.choice(n, QUERIES, replace=False)
    queries = table[qrows]
    log(f"phase 9, retrieval over embed()'s output ({n} x {d} float32, "
        f"{table.nbytes / 1e9:.3f} GB): {QUERIES} queries, top_k={TOP_K}")
    t0 = time.perf_counter()
    held = search.ANNIndex(g, table, method="brute").query_batch(
        queries[:HELD_QUERIES], TOP_K)
    log(f"  host brute force, {HELD_QUERIES} queries: "
        f"{time.perf_counter() - t0:.3f} s with its build")

    t0 = time.perf_counter()
    ann = search.ANNIndex(g, table, method="device")
    log(f"  ANNIndex(method='device') built in "
        f"{time.perf_counter() - t0:.3f} s")
    got, launches = timed_query("ANNIndex.query_batch",
                                lambda: ann.query_batch(queries, TOP_K))
    assert launches == dict.fromkeys(launches, 0)  # library calls only
    check_neighbours("ANNIndex.query_batch", got, qrows, held)
    # exact top-k: the full-float32 product's flops, against reading the
    # table and the queries once and writing the top-k once
    ops_ms = 2 * QUERIES * n * d / FP32_FLOP_PER_S * 1e3
    bytes_ms = (4 * (n + QUERIES) * d + 12 * QUERIES * TOP_K) \
        / HBM_BYTES_PER_S * 1e3
    log(f"  exact top-k bound per batch: {max(ops_ms, bytes_ms):.3f} ms "
        f"(operations {ops_ms:.3f}, bytes {bytes_ms:.3f})")
    del ann
    torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        idx = search.ShardedDeviceIndex(g, table, dtype=dtype)
        log(f"  ShardedDeviceIndex({dtype}) built in "
            f"{time.perf_counter() - t0:.3f} s")
        got, _ = timed_query(f"ShardedDeviceIndex({dtype}).query_batch",
                             lambda: idx.query_batch(queries, TOP_K))
        check_neighbours(f"ShardedDeviceIndex({dtype})", got, qrows, held,
                         table if dtype == "bfloat16" else None)
        del idx
        torch.cuda.empty_cache()

    # ---- PQ: codebooks from a sample on the host, every row encoded here
    t0 = time.perf_counter()
    sample = table[rng.choice(n, PQ_SAMPLE, replace=False)]
    trained = compress.product_quantize(sample, PQ_SUBSPACES, PQ_CENTROIDS,
                                        seed=0)
    kmeans_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes = encode_rows(table, trained._codebooks, dev)
    log(f"  product_quantize(M={PQ_SUBSPACES}, C={PQ_CENTROIDS}) on "
        f"{PQ_SAMPLE} sampled rows: {kmeans_s:.3f} s on the host; "
        f"{n} rows encoded on the card in {time.perf_counter() - t0:.3f} s")
    pq = compress.PQIndex(codes, trained._codebooks, PQ_SUBSPACES,
                          d // PQ_SUBSPACES, table.shape, device=dev)
    res, launches = timed_query(
        "PQIndex.search_batch(backend='device')",
        lambda: pq.search_batch(queries, TOP_K, backend="device"))
    assert launches == dict.fromkeys(launches, 0) | {"pq_adc": 1}, launches
    t0 = time.perf_counter()
    host = pq.search_batch(queries[:PQ_HOST_QUERIES], TOP_K,
                           backend="host")
    log(f"  PQIndex.search_batch(backend='host'), {PQ_HOST_QUERIES} "
        f"queries: {time.perf_counter() - t0:.3f} s")
    qn = queries[:PQ_HOST_QUERIES] / np.linalg.norm(
        queries[:PQ_HOST_QUERIES], axis=1, keepdims=True)
    tabs = np.einsum("qmd,mcd->qmc",
                     qn.reshape(PQ_HOST_QUERIES, PQ_SUBSPACES, -1),
                     pq._normalized_codebooks()).astype(np.float32)

    def host_scores(qi, rows):
        return sum(tabs[qi, m, codes[rows, m]] for m in range(PQ_SUBSPACES))

    np.testing.assert_allclose(res["scores"][:PQ_HOST_QUERIES],
                               host["scores"], rtol=0, atol=1e-5)
    for qi in range(PQ_HOST_QUERIES):
        got_idx, want_idx = res["indices"][qi], host["indices"][qi]
        diff = np.abs(host_scores(qi, got_idx) - host_scores(qi, want_idx))
        assert np.all((got_idx == want_idx) | (diff <= 1e-6)), qi
    log(f"  PQ device search against the host on {PQ_HOST_QUERIES} queries: "
        "scores atol=1e-5, the same indices but for ties")
    sub = d // PQ_SUBSPACES
    tab_ops_ms = 2 * QUERIES * PQ_SUBSPACES * PQ_CENTROIDS * sub \
        / FP32_FLOP_PER_S * 1e3
    tab_bytes_ms = 4 * (QUERIES * d + PQ_SUBSPACES * PQ_CENTROIDS * sub
                        + QUERIES * PQ_SUBSPACES * PQ_CENTROIDS) \
        / HBM_BYTES_PER_S * 1e3
    topk_ms = (4 * QUERIES * n + 12 * QUERIES * TOP_K) / HBM_BYTES_PER_S * 1e3
    log(f"  PQ bounds per batch: tables {max(tab_ops_ms, tab_bytes_ms):.4f}"
        f" ms (operations {tab_ops_ms:.4f}, bytes {tab_bytes_ms:.4f}); "
        f"top-k over the {QUERIES} x {n} scores {topk_ms:.3f} ms (bytes)")

    # ---- K13 at the main path's shape, against plain, and timed
    codes_dev = device_codes(codes, PQ_CENTROIDS, dev)
    qall = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    cb = torch.from_numpy(pq._normalized_codebooks().astype(np.float32)).to(
        dev)
    with full_float32_matmul():
        tables = torch.einsum("qmd,mcd->qmc", torch.from_numpy(
            qall.reshape(QUERIES, PQ_SUBSPACES, -1)).to(dev), cb).contiguous()
    got = pq_adc(tables, codes_dev)
    want, k13_plain_ms = timed_once(lambda: pq_adc_plain(tables, codes_dev))
    assert torch.equal(got, want)
    k13_err = max_err(got, want)
    del got, want
    k13_ms = time_ms(lambda: pq_adc(tables, codes_dev), reps=5)
    k13_bytes = 4 * tables.numel() + codes.size + 4 * QUERIES * n
    # the library's gather-sum on the same inputs: one embedding_bag over
    # the (M*C, Q) transposed tables, each row's bag its M codes offset by
    # m*C; gives the (N, Q) scores
    t0 = time.perf_counter()
    weight = tables.permute(1, 2, 0).reshape(PQ_SUBSPACES * PQ_CENTROIDS,
                                             QUERIES)
    bags = codes_dev.long() + PQ_CENTROIDS * torch.arange(PQ_SUBSPACES,
                                                          device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    lib = F.embedding_bag(bags, weight, mode="sum")
    got = pq_adc(tables, codes_dev)
    step = 1 << 17
    lib_err = max(float((got[:, i:i + step].T - lib[i:i + step]).abs().max())
                  for i in range(0, n, step))
    del got, lib
    # M terms of magnitude <= 1 added in another order: a few ulps of M
    assert lib_err <= 1e-5, lib_err
    lib_ms = time_ms(lambda: F.embedding_bag(bags, weight, mode="sum"),
                     reps=5)
    log(f"K13 (Q={QUERIES}, N={n}, M={PQ_SUBSPACES}, C={PQ_CENTROIDS}) "
        f"{k13_ms:.3f} ms (plain {k13_plain_ms:.3f}), bitwise equal; "
        f"bound {k13_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; library "
        f"embedding_bag {lib_ms:.3f} ms (its index offsets and transposed "
        f"tables made beforehand in {prep_s * 1e3:.3f} ms), max |err| "
        f"against K13 {lib_err:.3e}; [{card}]")
    del tables, codes_dev, pq, weight, bags
    torch.cuda.empty_cache()

    # ---- k-means assignment on the planted partition's embedding: the
    # card against the CPU
    t0 = time.perf_counter()
    a = community.detect_communities_kmeans(gq, emb_q, KMEANS_K, device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = community.detect_communities_kmeans(gq, emb_q, KMEANS_K, device="cpu")
    agree = np.mean([a[e] == b[e] for e in gq.entity_ids])
    log(f"  detect_communities_kmeans(k={KMEANS_K}) on the planted "
        f"partition's embedding ({emb_q.shape[0]} x {emb_q.shape[1]}): card "
        f"{card_s:.3f} s, CPU {time.perf_counter() - t0:.3f} s, labels "
        f"agree on {agree:.5f} of rows")
    assert agree >= 0.999, agree
    rows_q, dim_q = emb_q.shape
    as_ops = 2 * rows_q * dim_q * KMEANS_K / FP32_FLOP_PER_S * 1e3
    as_bytes = 4 * (rows_q * dim_q + KMEANS_K * dim_q) / HBM_BYTES_PER_S \
        * 1e3 + 8 * rows_q / HBM_BYTES_PER_S * 1e3
    log(f"  k-means assignment bound per iteration: "
        f"{max(as_ops, as_bytes):.4f} ms (operations {as_ops:.4f}, bytes "
        f"{as_bytes:.4f})")

    return [kernel_row("pq_adc", "cleora_tpu_torch/kernels/pq_adc.cu",
                       "cleora_tpu/compress.py:149", k13_ms, k13_plain_ms,
                       lib_ms, k13_err, k13_bytes, 0, launches["pq_adc"])]


def rel_err(got, want) -> float:
    """max |got − want| over max |want|, over lists of arrays."""
    return max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
               for a, b in zip(got, want))


def config4_auc(device) -> float:
    """BASELINE config 4 (scripts/e2e_configs.py:75-120) through the port:
    per-relation embeds, an 80/20 edge split, Cleora + ProNE concatenated,
    link-prediction AUC."""
    import cleora_tpu_torch as ctt
    from cleora_tpu_torch import algorithms, ensemble, metrics
    from cleora_tpu_torch.hetero import HeteroGraph
    from cleora_tpu_torch.sampling import train_test_split_edges

    rng = np.random.default_rng(5)
    h = HeteroGraph()
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

    h.add_edge_type("buys", "user", "item", [biased_pair() for _ in range(2000)])
    h.add_edge_type("views", "user", "item",
                    [biased_pair() for _ in range(3000)])
    h.embed_per_relation(feature_dim=64, num_iterations=10, device=device)
    g = ctt.SparseMatrix.from_iterator(iter(h.to_homogeneous_edges()),
                                       "complex::reflexive::node")
    split = train_test_split_edges(g, test_ratio=0.2)
    train_g = ctt.SparseMatrix.from_iterator(
        iter(split["train_edge_strings"]), "complex::reflexive::node")
    cleora = ctt.embed(train_g, feature_dim=64, num_iterations=10,
                       whiten=False, device=device)
    prone = algorithms.embed_prone(train_g, feature_dim=64)
    combo = ensemble.combine([cleora, prone], method="concat")
    known = set(train_g.entity_ids)
    test = [(a, b) for a, b in split["test_edges"]
            if a in known and b in known]
    return metrics.link_prediction_scores(train_g, combo, test)["auc"]


def node_classification(dev: torch.device, card: str, big) -> list:
    """Phase 10: BASELINE config 3 at full width, the classifiers card
    against CPU, K14/K15/K1-over-the-transpose at phase 5's size, and
    BASELINE config 4."""
    import tempfile

    import torch.nn.functional as F

    import cleora_tpu_torch as ctt
    import cleora_tpu_torch.classify as cl
    import cleora_tpu_torch.datasets as datasets
    import cleora_tpu_torch.metrics as metrics
    from cleora_tpu_torch.ops.gcn import (
        relu_dropout,
        relu_dropout_backward,
        relu_dropout_backward_plain,
        relu_dropout_plain,
    )
    from cleora_tpu_torch.ops.label_prop import (
        label_prop_step,
        label_prop_step_plain,
    )
    from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm, spmm_plain

    # ---- (a) BASELINE config 3: ogbn-arxiv's shape, embed, classifiers
    with tempfile.TemporaryDirectory() as cache:
        datasets._CACHE_DIR = datasets._COMPAT_CACHE_DIR = cache
        t0 = time.perf_counter()
        d = datasets.load_dataset("ogbn_arxiv")
        gen_s = time.perf_counter() - t0
    assert (d["num_nodes"], d["num_edges"], d["num_classes"]) == (
        ARXIV_NODES, ARXIV_EDGES, ARXIV_CLASSES), d["num_edges"]
    t0 = time.perf_counter()
    g = ctt.SparseMatrix.from_iterator(iter(d["edges"]), d["columns"])
    ingest_s = time.perf_counter() - t0
    labels = d["labels"]
    log(f"phase 10, BASELINE config 3: ogbn-arxiv's shape generated in "
        f"{gen_s:.3f} s ({ARXIV_NODES} nodes, {ARXIV_EDGES} edges, "
        f"{ARXIV_CLASSES} classes), ingested in {ingest_s:.3f} s: "
        f"{g.num_entities} entities, {g.num_edges} nnz")
    hub_census("BASELINE config 3 (ogbn-arxiv's shape)", g)
    emb, launches = run_main_path("  embed(D=256, 40 iterations)",
                                  lambda: ctt.embed(
                                      g, feature_dim=DIM,
                                      num_iterations=ITERATIONS, whiten=True))
    none = dict.fromkeys(launches, 0)
    assert launches == none | {"spmm_csr": ITERATIONS,
                               "hash_init": 1}, launches
    check_covariance(emb, dev)
    t0 = time.perf_counter()
    cent = metrics.node_classification_scores(g, emb, labels)["accuracy"]
    log(f"  node_classification_scores (centroid, host): accuracy "
        f"{cent:.4f} in {time.perf_counter() - t0:.3f} s (JAX package: "
        "0.998)")
    assert cent >= CENTROID_MIN, cent

    t0 = time.perf_counter()
    probe, launches = run_main_path(
        f"  mlp_classify(hidden_dim=0, num_epochs={PROBE_EPOCHS})",
        lambda: cl.mlp_classify(g, emb, labels, hidden_dim=0,
                                num_epochs=PROBE_EPOCHS))
    probe_s = time.perf_counter() - t0
    assert launches == none, launches  # library calls only
    steps = PROBE_EPOCHS * -(-probe["train_size"] // 256)
    # one step's bound: a (256, D) batch and its labels read, W and b read
    # and written; forward and backward GEMMs, 6·B·D·C flops
    b, c = 256, ARXIV_CLASSES
    step_bytes = 4 * b * DIM + 8 * b + 2 * 4 * (DIM * c + c)
    step_bound = max(step_bytes / HBM_BYTES_PER_S,
                     6 * b * DIM * c / FP32_FLOP_PER_S) * 1e3
    log(f"  linear probe: accuracy {probe['accuracy']:.4f}, macro-F1 "
        f"{probe['macro_f1']:.4f}, {steps} SGD steps, "
        f"{probe_s / steps * 1e3:.3f} ms per step with the evaluations "
        f"(bound of one step {step_bound:.5f} ms)")
    lp, launches = run_main_path(
        "  label_propagation_predict()",
        lambda: cl.label_propagation_predict(g, emb, labels))
    assert launches == none | {"label_prop": LP_ITERATIONS}, launches
    lp_launches = launches["label_prop"]
    log(f"  label propagation: accuracy {lp['accuracy']:.4f}")
    gcn, launches = run_main_path(
        "  gcn_classify()", lambda: cl.gcn_classify(g, emb, labels))
    evals = sum(1 for e in range(GCN_EPOCHS)
                if e % 10 == 0 or e == GCN_EPOCHS - 1) + 1
    assert launches == none | {
        "spmm_csr": 3 * GCN_EPOCHS + 2 * evals,
        "relu_dropout": GCN_EPOCHS + evals,
        "relu_dropout_backward": GCN_EPOCHS}, launches
    gcn_launches = launches
    log(f"  GCN: accuracy {gcn['accuracy']:.4f}, macro-F1 "
        f"{gcn['macro_f1']:.4f} ({evals} forward passes to evaluate)")

    arxiv = (d["edges"], d["columns"], emb)

    # ---- card against CPU on the same embedding
    train, _ = cl._propagation_split(g, labels, 0.8, 42)
    Y, labeled, _ = cl._label_matrix(g, train)
    rows, cols, svals, n = cl._row_normalized(g)
    f_dev = cl._propagate_labels(
        CsrMatrix.from_coo(rows, cols, svals, n, dev),
        torch.from_numpy(Y).to(dev), torch.from_numpy(labeled).to(dev), 0.5,
        LP_PARITY_ITERATIONS).cpu().numpy()
    t0 = time.perf_counter()
    f_cpu = cl._propagate_labels(
        CsrMatrix.from_coo(rows, cols, svals, n, "cpu"), torch.from_numpy(Y),
        torch.from_numpy(labeled), 0.5, LP_PARITY_ITERATIONS).numpy()
    top2 = np.sort(f_cpu, axis=1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] <= 1e-6
    same = f_dev.argmax(1) == f_cpu.argmax(1)
    assert np.all(same | tie), int((~same & ~tie).sum())
    log(f"  label propagation card vs CPU, {LP_PARITY_ITERATIONS} iterations "
        f"({time.perf_counter() - t0:.3f} s on the CPU): max |F err| {np.abs(f_dev - f_cpu).max():.3e}, "
        f"predictions equal on {same.mean():.6f} of rows, every other row a "
        f"near-tie ({int(tie.sum())} rows within 1e-6)")

    node_idx, y_mapped, classes, tr, te, rng = cl._labeled_split(
        g, labels, 0.8, 42)
    dims = [DIM, GCN_HIDDEN, len(classes)]
    init = [cl._he(rng, dims[i], dims[i + 1]) for i in range(2)]

    def gcn_steps(device):
        adj = cl._gcn_operators(g, device)
        params = init
        for epoch in range(GCN_PARITY_EPOCHS):
            params = cl._gcn_step(params, emb, adj, node_idx[tr],
                                  y_mapped[tr], 0.01, 1e-4, 0.5, 42, epoch)
        return params

    t0 = time.perf_counter()
    err = rel_err(gcn_steps(dev), gcn_steps("cpu"))
    log(f"  GCN {GCN_PARITY_EPOCHS} epochs at dropout 0.5, card vs CPU "
        f"({time.perf_counter() - t0:.3f} s): parameters within {err:.3e} "
        "relative (the same Philox masks)")
    assert err <= 1e-4, err
    X = emb[node_idx]
    probe_init = cl._mlp_init(np.random.default_rng(3), DIM, 0, len(classes))
    t0 = time.perf_counter()
    runs = [cl._mlp_train(probe_init, X[tr], y_mapped[tr], X[te],
                          y_mapped[te], np.random.default_rng(7), 1, 0.01,
                          1e-4, device)[0] for device in (dev, "cpu")]
    err = rel_err(*[[v.detach().cpu().numpy() for v in r.values()]
                    for r in runs])
    log(f"  linear probe, one epoch card vs CPU ({time.perf_counter() - t0:.3f}"
        f" s): parameters within {err:.3e} relative")
    assert err <= 1e-4, err
    batches = -(-len(tr) // 256)
    device_busy(f"one epoch of the linear probe ({batches} steps)",
                lambda: cl._mlp_train(probe_init, X[tr], y_mapped[tr], X[te],
                                      y_mapped[te], np.random.default_rng(7),
                                      1, 0.01, 1e-4, dev), batches, "step")
    adj = cl._gcn_operators(g, dev)
    x_dev = torch.from_numpy(emb).to(dev)
    device_busy("10 GCN epochs (2 evaluations)",
                lambda: cl._gcn_train(init, x_dev, adj, node_idx[tr],
                                      y_mapped[tr], node_idx[te],
                                      y_mapped[te], 10, 0.01, 1e-4, 0.5, 42),
                10, "epoch")
    del adj, x_dev
    del f_dev, f_cpu, emb, X
    torch.cuda.empty_cache()

    # ---- (b) K14, K15 and K1 over the transpose at phase 5's size
    rows, cols, svals, n = cl._row_normalized(big)
    S = CsrMatrix.from_coo(rows, cols, svals, n, dev)
    nnz = S.nnz
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        s_lib = torch.sparse_csr_tensor(S.indptr.int(), S.indices, S.vals,
                                        size=(n, n), check_invariants=False)
    k14 = {}
    for c in K14_FULL_WIDTHS:
        f, y, mask = label_state(n, c, dev, c)
        buf = torch.empty_like(f)
        got = label_prop_step(S, f, y, mask, 0.5, 0.5, out=buf)
        want, plain_ms = timed_once(
            lambda: label_prop_step_plain(S, f, y, mask, 0.5, 0.5))
        torch.cuda.synchronize()
        assert torch.equal(got[mask], y[mask])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        err = max_err(got, want)

        def library():
            return torch.where(mask[:, None], y,
                               0.5 * torch.sparse.mm(s_lib, f) + 0.5 * y)

        lib_err = max_err(library(), want)
        ms = time_ms(lambda: label_prop_step(S, f, y, mask, 0.5, 0.5,
                                             out=buf))
        lib_ms = time_ms(library)
        nbytes = 8 * (n + 1) + 8 * nnz + 3 * 4 * n * c + n
        flops = 2 * nnz * c + 3 * n * c
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
        log(f"K14 C={c} over {n} rows, {nnz} nnz: {ms:.3f} ms (plain "
            f"{plain_ms:.3f}, torch.sparse.mm + tail + where {lib_ms:.3f}, "
            f"max |err| {lib_err:.3e}); bound {bound:.3f} ms; max |err| "
            f"{err:.3e}; [{card}]")
        k14[c] = (ms, plain_ms, lib_ms, err, nbytes, flops)
        del f, y, mask, buf, got, want
    del S, s_lib

    gen = torch.Generator(device=dev).manual_seed(10)
    z = torch.randn((n, GCN_HIDDEN), device=dev, generator=gen)
    dh = torch.randn((n, GCN_HIDDEN), device=dev, generator=gen)
    args = (0.5, 42, 7, 0)
    h, mask = relu_dropout(z, *args)
    (h_plain, mask_plain), k15_plain_ms = timed_once(
        lambda: relu_dropout_plain(z, *args))
    dz = relu_dropout_backward(mask, dh, 0.5)
    dz_plain, bwd_plain_ms = timed_once(
        lambda: relu_dropout_backward_plain(mask, dh, 0.5))
    assert torch.equal(h, h_plain) and torch.equal(mask, mask_plain)
    assert torch.equal(dz, dz_plain)
    del h_plain, mask_plain, dz_plain
    k15_ms = time_ms(lambda: relu_dropout(z, *args))
    bwd_ms = time_ms(lambda: relu_dropout_backward(mask, dh, 0.5))
    # the library: one F.dropout(F.relu) and its autograd backward
    k15_lib_ms = time_ms(lambda: F.dropout(F.relu(z), 0.5))
    z_leaf = z.detach().requires_grad_()
    y_lib = F.dropout(F.relu(z_leaf), 0.5)
    bwd_lib_ms = time_ms(lambda: torch.autograd.grad(y_lib, z_leaf, dh,
                                                     retain_graph=True))
    del z_leaf, y_lib
    elems = n * GCN_HIDDEN
    # read z, write h and the bits; read the bits and dh, write dz
    k15_bytes = 8 * elems + 4 * (elems + 31) // 32
    log(f"K15 ({n}, {GCN_HIDDEN}) p=0.5: forward {k15_ms:.3f} ms (plain "
        f"{k15_plain_ms:.3f}, F.dropout(F.relu) {k15_lib_ms:.3f}; bound "
        f"{k15_bytes / HBM_BYTES_PER_S * 1e3:.3f} for 8.125 B an element, "
        f"{8 * elems / HBM_BYTES_PER_S * 1e3:.3f} for the 8 B of the "
        f"design that drew the mask again), backward {bwd_ms:.3f} ms "
        f"(plain {bwd_plain_ms:.3f}, autograd backward of F.dropout(F.relu) "
        f"{bwd_lib_ms:.3f}; bound {k15_bytes / HBM_BYTES_PER_S * 1e3:.3f} "
        f"for 8.125 B an element, {12 * elems / HBM_BYTES_PER_S * 1e3:.3f} "
        f"for the 12 B of the design that read z again); all bitwise equal "
        f"to plain; a hidden layer keeps {mask.numel() * 4 / 2**20:.1f} MiB "
        f"of bits for its backward, not {elems * 4 / 2**20:.1f} MiB of z; "
        f"[{card}]")
    del z, dh, h, dz, mask

    a_hat, a_hat_t = cl._gcn_operators(big, dev)
    dout = torch.randn((n, GCN_HIDDEN), device=dev, generator=gen)
    gcn_k1 = {}  # K1 over the GCN operator (forward) and its transpose
    for label, op in (("A_hat", a_hat), ("A_hat^T", a_hat_t)):
        got = spmm(op, dout)
        want, plain_ms = timed_once(lambda: spmm_plain(op, dout))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        err = max_err(got, want)
        lib_op = sparse_csr(op)
        ms = time_ms(lambda: spmm(op, dout))
        lib_ms = time_ms(lambda: torch.sparse.mm(lib_op, dout))
        nbytes = 8 * (n + 1) + 8 * op.nnz + 2 * 4 * n * GCN_HIDDEN
        flops = 2 * op.nnz * GCN_HIDDEN
        floor = op.nnz * (8 + 4 * GCN_HIDDEN) + 4 * n * GCN_HIDDEN
        gcn_k1[label] = (ms, plain_ms, lib_ms, err, nbytes, flops)
        log(f"K1 over the GCN operator {label} ({op.nnz} nnz) "
            f"d={GCN_HIDDEN}: {ms:.3f} ms (plain {plain_ms:.3f}, "
            f"torch.sparse.mm {lib_ms:.3f}); bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms, one row per entry "
            f"{floor / HBM_BYTES_PER_S * 1e3:.3f} ms; launches in the GCN "
            f"(both operators) {gcn_launches['spmm_csr']}; [{card}]")
        del got, want, lib_op
    del a_hat, a_hat_t, dout
    torch.cuda.empty_cache()

    # ---- (c) BASELINE config 4: card against CPU
    t0 = time.perf_counter()
    auc_card = config4_auc(dev)
    card_s = time.perf_counter() - t0
    auc_cpu = config4_auc("cpu")
    log(f"  BASELINE config 4: link-prediction AUC card {auc_card:.4f} "
        f"({card_s:.3f} s), CPU {auc_cpu:.4f}")
    assert abs(auc_card - auc_cpu) <= 0.01, (auc_card, auc_cpu)

    ms, plain_ms, lib_ms, err, nbytes, flops = k14[ARXIV_CLASSES]
    return arxiv, [
        kernel_row("label_prop", "cleora_tpu_torch/kernels/label_prop.cu",
                   "cleora_tpu/classify.py:88", ms, plain_ms, lib_ms, err,
                   nbytes, flops, lp_launches),
        kernel_row("relu_dropout", "cleora_tpu_torch/kernels/relu_dropout.cu",
                   "cleora_tpu/classify.py:131", k15_ms, k15_plain_ms,
                   k15_lib_ms, 0.0, k15_bytes, 0,
                   gcn_launches["relu_dropout"]),
        kernel_row("relu_dropout_backward",
                   "cleora_tpu_torch/kernels/relu_dropout.cu",
                   "cleora_tpu/classify.py:149", bwd_ms, bwd_plain_ms,
                   bwd_lib_ms, 0.0, k15_bytes, 0,
                   gcn_launches["relu_dropout_backward"]),
        kernel_row("spmm_csr_gcn", "cleora_tpu_torch/kernels/spmm_csr.cu",
                   "cleora_tpu/classify.py:125", *gcn_k1["A_hat"],
                   gcn_launches["spmm_csr"]),
        kernel_row("spmm_csr_transposed",
                   "cleora_tpu_torch/kernels/spmm_csr.cu",
                   "cleora_tpu/classify.py:149", *gcn_k1["A_hat^T"],
                   gcn_launches["spmm_csr"]),
    ]


def write_edge_text(path: str, src: np.ndarray, dst: np.ndarray,
                    chunk: int = 1_000_000) -> None:
    """One "src dst" line per edge: the lines from_edge_arrays builds."""
    with open(path, "w") as f:
        for s in range(0, len(src), chunk):
            pairs = np.column_stack([src[s:s + chunk],
                                     dst[s:s + chunk]]).ravel().tolist()
            f.write(("%d %d\n" * (len(pairs) // 2)) % tuple(pairs))


@contextlib.contextmanager
def one_rank_nccl_group():
    """A one-rank NCCL process group over an in-process store."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def streamed_sharded(dev: torch.device, card: str, big, table: np.ndarray,
                     arxiv) -> list:
    """Phase 11: the streamed build, embed(DiskGraph) through the sharded
    loop without a group and in a one-rank NCCL group, its halo path,
    checkpoint/resume and .npy output, K16 at full width, and the CLI.
    Returns the kernels' rows and what phase 14 takes over: (b)'s output,
    the 4-way ShardedCoo and its halo plan."""
    import io
    import tempfile

    import cleora_tpu_torch as ctt
    from cleora_tpu_torch.cli import main as cli_main
    from cleora_tpu_torch.graph.stream import build_graph_streaming
    from cleora_tpu_torch.ops.halo import halo_pack, halo_pack_plain
    from cleora_tpu_torch.parallel import embed_sharded
    from cleora_tpu_torch.parallel import state as lifecycle
    from cleora_tpu_torch.parallel.shard import plan_halo, shard_graph

    data = big.data
    n = data.num_entities
    rows = np.sort(np.random.default_rng(11).choice(
        n, size=STREAM_SAMPLE, replace=False))
    kw = dict(feature_dim=DIM, num_iterations=ITERATIONS, whiten=True)
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a) the streamed build, bitwise against the in-RAM build
        t0 = time.perf_counter()
        path = os.path.join(tmp, "edges.txt")
        write_edge_text(path, *synthetic_edges(FULL_NODES, FULL_UND_EDGES, 7))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dg = build_graph_streaming([path], "complex::reflexive::node",
                                   os.path.join(tmp, "g"), files=True)
        build_s = time.perf_counter() - t0
        for name in ("indptr", "indices", "left_vals", "sym_vals",
                     "entity_hashes", "column_ids"):
            assert (np.asarray(getattr(dg, name)).tobytes()
                    == np.asarray(getattr(data, name)).tobytes()), name
        assert dg.entity_ids_range(0, 1000) == data.entity_ids[:1000]
        log(f"phase 11: {os.path.getsize(path) / 1e6:.1f} MB of edge text "
            f"written in {write_s:.3f} s, stream-built in {build_s:.3f} s "
            f"({dg.num_entities} entities, {dg.num_edges} nnz), CSR, values "
            "and hashes bitwise equal to phase 5's SparseMatrix")

        # ---- (b) embed(DiskGraph) without a process group
        out_b, launches = run_main_path("  embed(DiskGraph)",
                                        lambda: ctt.embed(dg, **kw))
        none = dict.fromkeys(launches, 0)
        loop = {"spmm_csr": ITERATIONS, "hash_init": 1}
        assert launches == none | loop, launches
        check_covariance(out_b, dev)
        err, top = gram_err(out_b, table, rows)
        raw = float(np.abs(out_b - table).max())
        log(f"  Gram of {STREAM_SAMPLE} rows against phase 5's embed(): max "
            f"|diff| {err:.3e} (entries up to {top:.1f}); raw rows max |diff| "
            f"{raw:.3e}" + (" (bitwise equal)" if raw == 0.0 else ""))
        assert err <= 2e-5, err

        # ---- (c) the same call in a one-rank NCCL group; its halo path
        with one_rank_nccl_group():
            out_c, launches = run_main_path(
                "  embed(DiskGraph), one-rank NCCL group",
                lambda: ctt.embed(dg, **kw))
            assert launches == none | loop, launches
            assert out_c.tobytes() == out_b.tobytes()
            out_h, halo_launches = run_main_path(
                "  embed_sharded(halo=True), one-rank NCCL group",
                lambda: embed_sharded(dg, halo=True, **kw))
            assert halo_launches == none | loop | {
                "halo_pack": ITERATIONS}, halo_launches
            assert out_h.tobytes() == out_b.tobytes()
        log("  one-rank NCCL group: all-gather and halo runs bitwise equal "
            "to the run without a group")
        del out_c, out_h

        # ---- (d) checkpoint/resume and .npy output
        ck = dict(kw, checkpoint_every=STREAM_CKPT_EVERY)
        t0 = time.perf_counter()
        whole = embed_sharded(dg, checkpoint_dir=os.path.join(tmp, "ck1"),
                              **ck)
        whole_s = time.perf_counter() - t0
        save = lifecycle.ShardedCheckpoint.save
        saves = []

        class Cut(Exception):
            pass

        def cut(self, x, iteration, extra=None):
            save(self, x, iteration, extra)
            saves.append(iteration)
            if len(saves) == STREAM_CUT_SAVES:
                raise Cut

        lifecycle.ShardedCheckpoint.save = cut
        try:
            embed_sharded(dg, checkpoint_dir=os.path.join(tmp, "ck2"), **ck)
        except Cut:
            pass
        finally:
            lifecycle.ShardedCheckpoint.save = save
        assert saves == [10, 20], saves
        resumed = embed_sharded(dg, checkpoint_dir=os.path.join(tmp, "ck2"),
                                **ck)
        assert resumed.tobytes() == whole.tobytes()
        npy = embed_sharded(dg, out=os.path.join(tmp, "e.npy"), **kw)
        assert np.array_equal(np.asarray(npy), out_b)
        log(f"  checkpointed run {whole_s:.3f} s ({ITERATIONS // STREAM_CKPT_EVERY}"
            f" saves); cut after {saves[-1]} iterations and resumed: bitwise "
            "equal to the uninterrupted run"
            + (", which equals (b)" if whole.tobytes() == out_b.tobytes()
               else "") + "; out='.npy' equal to (b)")
        del whole, resumed, npy

        # ---- (e) K16 on shard 0's send slabs of a 4-way halo plan
        t0 = time.perf_counter()
        sharded = shard_graph(big, "left", K16_SHARDS)
        plan = plan_halo(sharded)
        plan_s = time.perf_counter() - t0
        rps = sharded.rows_per_shard
        send = torch.from_numpy(np.ascontiguousarray(
            plan.send_idx[0])).to(dev)
        p, m = send.shape
        block = torch.from_numpy(table[:rps]).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = block.to(dtype)
            got = halo_pack(x, send)
            torch.cuda.synchronize()
            assert torch.equal(got, halo_pack_plain(x, send)), dtype
        del x, got
        k16_ms = time_ms(lambda: halo_pack(block, send))
        k16_plain_ms = time_ms(lambda: halo_pack_plain(block, send))
        k16_lib_ms = time_ms(lambda: block.index_select(0, send.flatten()))
        # bound: each distinct row the slabs name read once, the slabs
        # written once, the indices read once
        distinct = int(torch.unique(send).numel())
        k16_bytes = 4 * distinct * DIM + 4 * p * m * DIM + 4 * p * m
        log(f"  K16 (P, M, D) = ({p}, {m}, {DIM}) from {rps} rows, {distinct} "
            f"of them distinct in the slabs (plan "
            f"{plan_s:.3f} s on the host): {k16_ms:.3f} ms (plain "
            f"{k16_plain_ms:.3f}, index_select {k16_lib_ms:.3f}); bound "
            f"{k16_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; bitwise equal to "
            f"plain in float32 and bfloat16; [{card}]")
        del block, send

        # ---- (f) the CLI, in-process
        edges, columns, emb = arxiv
        path = os.path.join(tmp, "arxiv.tsv")
        with open(path, "w") as f:
            f.write("\n".join(edges) + "\n")
        npy_path = os.path.join(tmp, "arxiv.npy")
        _, launches = run_main_path("  cli embed --streaming", lambda: cli_main(
            ["embed", "-i", path, "-c", columns, "--streaming",
             os.path.join(tmp, "arxiv_g"), "-o", npy_path, "-d", str(DIM),
             "-n", str(ITERATIONS)]))
        assert launches == none | loop, launches
        cli_out = np.load(npy_path)
        sample = np.sort(np.random.default_rng(12).choice(
            emb.shape[0], size=STREAM_SAMPLE, replace=False))
        err, top = gram_err(cli_out, emb, sample)
        log(f"  cli embed --streaming: Gram of {STREAM_SAMPLE} rows against "
            f"phase 10's embed(): max |diff| {err:.3e} (entries up to "
            f"{top:.1f}); raw max |diff| "
            f"{float(np.abs(cli_out - emb).max()):.3e}")
        assert err <= 2e-5, err
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(["info", "-i", path, "-c", columns])
        info = buf.getvalue()
        log("  cli info: " + info.splitlines()[0])
        assert f"{emb.shape[0]} entities" in info, info

    return [kernel_row("halo_pack", "cleora_tpu_torch/kernels/halo_pack.cu",
                       "cleora_tpu/parallel/embed.py:138", k16_ms,
                       k16_plain_ms, k16_lib_ms, 0.0, k16_bytes, 0,
                       halo_launches["halo_pack"])], {
        "out_b": out_b, "sharded": sharded, "plan": plan}


# --------------------------------------- phase 12: the sharded siblings
def sharded_siblings(dev: torch.device, card: str, g, refs: dict) -> list:
    """Phase 12: the five spectral siblings with n_devices=1 in a one-rank
    NCCL group (parallel/algorithms.py), each a main path against phase
    6's single-device run; K5 with a separate self_ operand and the
    distributed linear algebra timed at full width."""
    import tempfile

    import cleora_tpu_torch.algorithms as alg
    import cleora_tpu_torch.parallel.algorithms as palg
    from cleora_tpu_torch._util import full_float32_matmul
    from cleora_tpu_torch.ops.spmm import spmm_axpy, spmm_axpy_plain
    from cleora_tpu_torch.parallel import make_mesh

    n, nnz = g.num_entities, g.num_edges
    rows = refs["rows"]
    prone_kw = {k: v.default for k, v in inspect.signature(
        alg.embed_prone).parameters.items() if k in ("mu", "theta", "seed")}
    sym_targets = ((palg, "_sharded_op_sym"), (palg.ShardedOp, "apply_axpy"),
                   (palg, "_gram_usqrt"), (palg, "_sharded_exit"),
                   (alg, "_finalize"))
    kept = {}
    log(f"phase 12, the sharded siblings with n_devices=1 in a one-rank NCCL "
        f"group, on phase 5's graph ({n} entities, {nnz} nnz)")
    with one_rank_nccl_group():
        # ---- (a) full width: ProNE (its U before the epilogue held
        # against the single-device Chebyshev core), RandNE, HOPE, out=
        seen = {}
        real_usqrt = palg._gram_usqrt

        def usqrt(U, mesh):
            seen["U"] = U
            return real_usqrt(U, mesh)

        def prone():
            return alg.embed_prone(g, feature_dim=DIM, backend="device",
                                   n_devices=1)

        palg._gram_usqrt = usqrt
        try:
            prone_launches = staged_spectral(
                "embed_prone(n_devices=1)", prone, {"spmm_axpy": 9},
                *sym_targets, keep=kept)
        finally:
            palg._gram_usqrt = real_usqrt
        prone_out = kept.pop("embed_prone(n_devices=1)")
        U = seen.pop("U")[:n]
        core = alg._prone_chebyshev_core(g, DIM, **prone_kw)
        torch.testing.assert_close(U, core, rtol=1e-5, atol=1e-6)
        log(f"  ProNE's U before the epilogue against _prone_chebyshev_core:"
            f" max |diff| {max_err(U, core):.3e}"
            + (" (bitwise equal)" if torch.equal(U, core) else ""))
        del U, core, prone_out

        def randne():
            return alg.embed_randne(g, feature_dim=DIM, backend="device",
                                    num_iterations=ITERATIONS, n_devices=1)

        staged_spectral("embed_randne(n_devices=1)", randne,
                        {"spmm_axpy": ITERATIONS}, *sym_targets, keep=kept)
        got = kept.pop("embed_randne(n_devices=1)")
        err = float(np.abs(got - refs["randne"]).max())
        log(f"  RandNE against phase 6's: max |diff| {err:.3e}"
            + (" (bitwise equal)" if err == 0.0 else ""))
        assert err <= 1e-6, err
        del got

        def hope():
            return alg.embed_hope(g, feature_dim=DIM, backend="device",
                                  n_devices=1)

        staged_spectral(
            "embed_hope(n_devices=1)", hope,
            {"spmm_axpy": 6 * refs["hope_terms"]},
            (palg.ShardedOp, "__init__"), (palg.ShardedOp, "apply_axpy"),
            (palg, "_chol_qr"), (torch.linalg, "eigh"),
            (palg, "_sharded_exit"), (alg, "_finalize"), keep=kept)
        got = kept.pop("embed_hope(n_devices=1)")[rows]
        err, top = gram_err(got, refs["hope"], slice(None))
        log(f"  HOPE against phase 6's: Gram of {len(rows)} rows max |diff| "
            f"{err:.3e} (entries up to {top:.1f})")
        assert err <= 5e-3, err
        del got

        # ---- K5 with self_ and the distributed linear algebra, timed
        mesh = make_mesh()
        op = palg._sharded_op_sym(g, mesh, DIM)
        rps, lnnz = op.rows_per_shard, op.csr.nnz
        gen = torch.Generator(device=dev).manual_seed(12)
        x, z, acc = (torch.randn((rps, DIM), device=dev, generator=gen)
                     for _ in range(3))
        table = mesh.all_gather(x)  # a copy in a group, as the path sees
        assert table is not x
        got, want = k5_self_pair(op.csr, table, x, z, acc)
        k5s_err = 0.0
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            k5s_err = max(k5s_err, max_err(a, b))
        del got, want, a, b
        ca, cb, cc, cd = K5_CASES["chebyshev"][:4]
        k5s_ms = time_ms(lambda: spmm_axpy(op.csr, table, ca, cb, z=z, c=cc,
                                           acc=acc, d=cd, self_=x))
        k5s_plain_ms = time_ms(
            lambda: spmm_axpy_plain(op.csr, table, ca, cb, z=z, c=cc,
                                    acc=acc, d=cd, self_=x),
            reps=3, warmup=1)
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            a_lib = torch.sparse_csr_tensor(
                op.csr.indptr.int(), op.csr.indices, op.csr.vals,
                size=(rps, table.shape[0]), check_invariants=False)

            def k5_library():
                out = torch.sparse.mm(a_lib, table).mul_(ca)
                out.add_(x, alpha=cb).add_(z, alpha=cc)
                acc.add_(out, alpha=cd)
                return out

            k5s_lib_ms = time_ms(k5_library)
        del a_lib
        # table, self_ and z read, acc read and written, out written
        k5s_bytes = 8 * (rps + 1) + 8 * lnnz + 4 * 4 * rps * DIM \
            + 8 * rps * DIM
        k5s_flops = 2 * lnnz * DIM + 7 * rps * DIM
        log(f"K5 with self_ D={DIM} (a {table.shape[0]}-row table copy): "
            f"Chebyshev step {k5s_ms:.3f} ms (plain {k5s_plain_ms:.3f}, "
            f"torch.sparse.mm + 4 elementwise calls {k5s_lib_ms:.3f}); "
            f"bound {k5s_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes); "
            f"max |err| {k5s_err:.3e}; [{card}]")
        del table, z, acc
        with full_float32_matmul():
            q = palg._chol_qr(x, mesh)
            ortho = max_err(torch.matmul(q.T, q),
                            torch.eye(DIM, device=dev))
            assert ortho <= 1e-4, ortho
            del q
            la = {name: time_ms(lambda f=f: f(x, mesh))
                  for name, f in (("_psum_gram", palg._psum_gram),
                                  ("_chol_qr", palg._chol_qr),
                                  ("_gram_usqrt", palg._gram_usqrt))}
        # flops: the Gram 2·n·D²; CholeskyQR2 two Grams and two triangular
        # solves of n·D² each; U·√S the Gram and one (n, D)·(D, D) product
        nd2 = rps * DIM * DIM
        for name, flops in (("_psum_gram", 2 * nd2), ("_chol_qr", 6 * nd2),
                            ("_gram_usqrt", 4 * nd2)):
            log(f"  {name} ({rps}, {DIM}): {la[name]:.3f} ms; bound "
                f"{flops / FP32_FLOP_PER_S * 1e3:.3f} ms (operations, float32 "
                f"outside the tensor cores); [{card}]")
        log(f"  CholeskyQR2 of ({rps}, {DIM}) Gaussian rows: max |QᵀQ - I| "
            f"{ortho:.3e}")
        del x, op

        # ---- (b) ProNE on phase 6's blocked graph; NetMF and GraRep,
        # blocked, on phase 6's dense graph (a cut from the blocked graph,
        # whose two runs took 35 s of a 700.8 s run of this script on an
        # NVIDIA H100 80GB HBM3 at 700 W)
        gb = refs["blocked"]
        brows = refs["blocked_rows"]
        log(f"phase 12 (b), phase 6's blocked graph ({gb.num_entities} "
            f"entities, {gb.num_edges} nnz)")
        staged_spectral("embed_prone(n_devices=1) blocked graph",
                        lambda: alg.embed_prone(gb, feature_dim=DIM,
                                                backend="device", n_devices=1),
                        {"spmm_axpy": 9}, *sym_targets, keep=kept)
        prone_out = kept.pop("embed_prone(n_devices=1) blocked graph")
        # out= on this graph (a cut from phase 5's, where it took 21-23 s)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "prone.npy")
            t0 = time.perf_counter()
            npy = alg.embed_prone(gb, feature_dim=DIM, backend="device",
                                  n_devices=1, out=path)
            out_s = time.perf_counter() - t0
            assert np.array_equal(np.asarray(npy), prone_out)
            del npy
        log(f"  embed_prone(n_devices=1, out='.npy') blocked graph: "
            f"{out_s:.3f} s, equal to the in-memory result")
        got = prone_out[brows]
        del prone_out
        err, top = gram_err(got, refs["blocked_prone"], slice(None))
        log(f"  prone against phase 6's single-device run: Gram of "
            f"{len(brows)} rows max |diff| {err:.3e} (entries up to "
            f"{top:.1f})")
        assert err <= 1e-3, err
        gd = refs["dense"]
        nd = gd.num_entities
        drows = sample_rows(nd)
        blocks = -(-nd // BLOCK_ROWS)
        sweeps = 2 + 2 * 1  # power_iters=1
        log(f"phase 12 (b), phase 6's dense graph ({nd} entities, "
            f"{gd.num_edges} nnz): block_rows={BLOCK_ROWS}, {blocks} blocks, "
            f"{sweeps} sweeps, against the single-device blocked path")
        blocked_targets = ((palg, "_sweep"), (palg, "_vblock"),
                           (palg, "log_clip"), (palg, "_chol_qr"),
                           (palg, "_sharded_exit"))
        cases = (
            ("netmf", alg.embed_netmf, {},
             {"spmm_axpy": blocks * sweeps * 5, "log_clip": blocks * sweeps},
             ((palg.ShardedOp, "apply_axpy"),) + blocked_targets),
            ("grarep", alg.embed_grarep, {"max_step": GRAREP_STEPS},
             {"spmm_csr": blocks * sweeps * GRAREP_STEPS,
              "log_clip": blocks * sweeps * GRAREP_STEPS},
             ((palg.ShardedOp, "apply"),) + blocked_targets),
        )
        for name, fn, extra, expected, targets in cases:
            kw = dict(extra, feature_dim=DIM, backend="device",
                      block_rows=BLOCK_ROWS, power_iters=1)
            t0 = time.perf_counter()
            ref = fn(gd, **kw)[drows]
            ref_s = time.perf_counter() - t0
            label = f"embed_{name}(n_devices=1) dense graph"
            staged_spectral(label, lambda: fn(gd, n_devices=1, **kw),
                            expected, *targets, keep=kept)
            got = kept.pop(label)[drows]
            err, top = gram_err(got, ref, slice(None))
            log(f"  {name} against the single-device blocked path "
                f"({ref_s:.3f} s): Gram of {len(drows)} rows max |diff| "
                f"{err:.3e} (entries up to {top:.1f}); "
                f"{kept['stages']['_sweep'] * 1e3 / (blocks * sweeps):.3f} "
                f"ms per block body (the sweeps' seconds over "
                f"{blocks * sweeps} blocks; L is ({nd}, {BLOCK_ROWS}), "
                f"{8 * nd * BLOCK_ROWS / HBM_BYTES_PER_S * 1e3:.3f} ms to "
                f"write and read once); [{card}]")
            assert err <= 1e-3, (name, err)

    return [kernel_row("spmm_axpy_self", "cleora_tpu_torch/kernels/spmm_axpy.cu",
                       "cleora_tpu/parallel/algorithms.py:449", k5s_ms,
                       k5s_plain_ms, k5s_lib_ms, k5s_err, k5s_bytes,
                       k5s_flops, prone_launches["spmm_axpy"])]


# -------------------------------------- phase 13: the walk siblings sharded
# phase 13's K17/K18 check: phase 3's weighted graph, walks short enough
# that the plain versions' rounds stay within seconds
K17_CHECK_WALKS = 4_096
K17_CHECK_LENGTH = 10
K18_PQ = ((0.5, 2.0), (2.0, 0.5))
# K18 is timed on walks of this length (its plain version takes about a
# second a hop at 131,072 lanes)
K18_TIMED_LENGTH = 10


@contextlib.contextmanager
def plain_walk_kernels():
    """K17's and K18's wrappers in ``kernels`` replaced by their plain
    versions, so that ops/walk.py's walk loops run the plain stages on the
    card's tensors (the plain versions' signatures are the wrappers'
    without the output buffer)."""
    import cleora_tpu_torch.ops.walk as walk
    from cleora_tpu_torch import kernels

    def into_out(plain):
        return lambda *args: args[-1].copy_(plain(*args[:-1]))

    def local(*args):
        out = args[-1]
        return out.copy_(walk.walk2_local_plain(*args[:-1],
                                                shared=out.dim() == 2))

    swaps = {"walk_owned": into_out(walk.walk_owned_hop_plain),
             "walk2_local": local,
             "walk2_propose": into_out(walk.walk2_propose_plain),
             "walk2_member": into_out(walk.walk2_member_plain),
             "walk2_decide": walk.walk2_decide_plain}
    saved = {name: getattr(kernels, name) for name in swaps}
    for name, fn in swaps.items():
        setattr(kernels, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def rank_slices(arrays, n: int, world: int, dev: torch.device) -> list:
    """The ``world`` rank slices of a walk CSR (``arrays``: indptr, cols,
    deg, and vals, wmax, wsum for the weighted tables) on ``dev``."""
    from cleora_tpu_torch.ops.walk import ShardedWalkTables

    indptr, cols, deg, *weights = arrays
    return [ShardedWalkTables(indptr, cols, deg, n, r, world, dev, *weights)
            for r in range(world)]


def check_k17_k18(dev: torch.device) -> None:
    """K17 and K18 with one rank's slice and with two (K17, K18) and four
    (K18) ranks' slices summed in this process, bitwise against K8 and K12
    and against their own plain versions on the card; K18 at one slice
    launches its local stage once a hop and nothing else."""
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops import walk

    n = K12_CHECK_NODES
    arrays = weighted_walk_csr(n, 5, HUB_DEGREE)
    t = walk.WalkTables2(*arrays[:3], n, *arrays[3:], dev)
    rng = np.random.default_rng(8)
    starts = rng.integers(0, n + 1, K17_CHECK_WALKS)  # n: pad lanes
    for i, node in enumerate((1, 2, n - 1, n)):  # hub, dead, isolated, pad
        starts[64 * i:64 * (i + 1)] = node
    starts = torch.from_numpy(starts.astype(np.int32)).to(dev)
    length, seed, base = K17_CHECK_LENGTH, 21, 5
    k8 = walk.walk_uniform(t.indptr, t.cols, t.deg, starts, length, seed,
                           base, n)
    for world in (1, 2, 4):
        if world < 4:
            first = rank_slices(arrays[:3], n, world, dev)
            before = kernels.LAUNCHES["walk_owned"]
            got = walk.walk_uniform_sharded(first, starts, length, seed,
                                            base)
            assert kernels.LAUNCHES["walk_owned"] == before + world * (
                length - 1)
            with plain_walk_kernels():
                plain = walk.walk_uniform_sharded(first, starts, length,
                                                  seed, base)
            assert torch.equal(got, k8) and torch.equal(plain, k8), world
        second = rank_slices(arrays, n, world, dev)
        for p, q in K18_PQ:
            inv_p = float(np.float32(1.0 / p))
            inv_q = float(np.float32(1.0 / q))
            args = (length, inv_p, inv_q, walk.walk2_tries(q), seed, base)
            k12 = walk.walk_p_q(t.indptr, t.cols, t.vals, t.deg, t.wmax,
                                t.wsum, starts, *args, n)
            before = kernels.LAUNCHES["walk2_owned"]
            got = walk.walk_p_q_sharded(second, starts, *args)
            launches = kernels.LAUNCHES["walk2_owned"] - before
            assert (launches == length - 1 if world == 1
                    else launches > world * (length - 1)), launches
            with plain_walk_kernels():
                plain = walk.walk_p_q_sharded(second, starts, *args)
            assert torch.equal(got, k12) and torch.equal(plain, k12), (
                world, p, q)
    torch.cuda.synchronize()
    log(f"K17 over 1 and 2 rank slices, K18 over 1, 2 and 4 "
        f"({K17_CHECK_WALKS} walks of {K17_CHECK_LENGTH} on a {n}-node "
        f"graph with a hub of degree {int(t.deg[1])}, a dead row, an "
        f"isolated node and pad lanes; K18 at (p, q) in {K18_PQ}, one "
        "local stage a hop at one slice): bitwise equal to K8, K12 and "
        "their plain versions on the card")


def k17_sector_bytes(walks: torch.Tensor, deg: torch.Tensor, n: int) -> int:
    """The bytes K17's hops need, in 32-byte sectors, as K8's: a live lane
    reads deg of its node and, when it moves, indptr and cols (one sector
    per random read); every hop reads the frontier and writes one int32 a
    lane."""
    reads = int((walks[:, :-1] < n).sum())
    moves = int((walks[:, 1:] < n).sum())
    return 32 * (reads + 2 * moves) + 8 * walks.shape[0] * (
        walks.shape[1] - 1)


def same_neighbours(got, want) -> int:
    """Query results of two indexes: the scores equal, and each index that
    differs sits on a score that is tied within the list or with the last
    one (a tie at the cut may let either row in).  Returns how many lists
    differ by such ties."""
    tied = 0
    for a, b in zip(got, want):
        sa = [r["similarity"] for r in a]
        assert sa == [r["similarity"] for r in b], (a, b)
        ia, ib = [r["index"] for r in a], [r["index"] for r in b]
        if ia != ib:
            assert all(x == y or sa.count(sa[i]) > 1 or sa[i] == sa[-1]
                       for i, (x, y) in enumerate(zip(ia, ib))), (ia, ib, sa)
            tied += 1
    return tied


def walk_siblings_sharded(dev: torch.device, card: str, g, p7: dict,
                          n2v_walks: torch.Tensor, big,
                          table: np.ndarray) -> list:
    """Phase 13: the walk siblings over a one-rank NCCL group with the
    walk tables cut by rows (K17, K18), the count ranges and the
    factorization on their rank, against phases 7 and 8; K17 and K18 timed;
    the row-sharded retrieval index against the unsharded one."""
    import cleora_tpu_torch.algorithms as alg
    import cleora_tpu_torch.ops.cooccur as cooccur
    import cleora_tpu_torch.ops.dense as dense
    import cleora_tpu_torch.ops.walk as walk
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.parallel import make_mesh
    from cleora_tpu_torch.search import ShardedDeviceIndex

    check_k17_k18(dev)
    n = g.num_entities
    passes = alg._cooc_passes(g, WALKS_PER_NODE, WALK_LENGTH, WINDOW)
    deg = alg._walk_csr(g)[2]
    batch = alg._WALK_BATCH // 2
    batches = -(-int((deg > 0).sum()) * WALKS_PER_NODE // batch)
    power_iters = inspect.signature(
        alg._device_counts_to_embeddings).parameters["power_iters"].default
    applies = 2 + 2 * power_iters
    rows = sample_rows(n)
    log(f"phase 13, the walk siblings in a one-rank NCCL group with the walk "
        f"tables cut by rows, on phase 7's corpus ({n} entities)")
    with one_rank_nccl_group():
        mesh = make_mesh()
        # ---- (b) DeepWalk: sharded tables, rank-parallel counting, the
        # sharded factorization
        first = next(iter(alg._device_walks(
            g, WALKS_PER_NODE, WALK_LENGTH, 0, batch=batch, resident=True,
            walk_tables="sharded", mesh=mesh)))[0]
        assert torch.equal(first.cpu(), p7["walks"])
        log(f"  the first walk batch {tuple(first.shape)} over the sharded "
            "tables (K17) bitwise equal to phase 7's (K8)")
        del first

        def deepwalk():
            return alg.embed_deepwalk(
                g, feature_dim=DIM, num_walks=WALKS_PER_NODE,
                walk_length=WALK_LENGTH, window_size=WINDOW,
                backend="device", cooccurrence="device", n_devices=1,
                walk_tables="sharded", factorization="sharded")

        expected = {"walk_owned": batches * (WALK_LENGTH - 1),
                    "pair_enum": batches,
                    "run_length": batches,
                    "run_length_merge": (batches - 1) * passes,
                    "ppmi": passes, "spmm_axpy": applies * passes}
        counted = {}
        real_counts = alg.device_pair_counts

        def counts(*args, **kwargs):
            # records what the run counted; adds no synchronisation
            ranges, m_total = real_counts(*args, **kwargs)
            counted["m_total"] = m_total
            counted["pairs"] = cooccur.pair_total(ranges, n)
            counted["ranges"] = [range_fingerprint(r, n) for r in ranges]
            return ranges, m_total

        kept = {}
        alg.device_pair_counts = counts
        try:
            launches = run_spectral("embed_deepwalk(sharded, n_devices=1)",
                                    deepwalk, expected, kept)
        finally:
            alg.device_pair_counts = real_counts
        got = kept.pop("embed_deepwalk(sharded, n_devices=1)")
        err, top = gram_err(got, p7["emb"], rows)
        raw = float(np.abs(got - p7["emb"]).max())
        log(f"  against phase 7's embedding: Gram of {len(rows)} rows max "
            f"|diff| {err:.3e} (entries up to {top:.1f}), largest raw "
            f"difference {raw:.3e}"
            + (" (bitwise equal)" if raw == 0.0 else ""))
        assert err <= 1e-4, err
        del got
        # the all-reduce of the sharded rsvd's (n, r) partial, timed alone
        # (its stopwatch run, which timed the applies, was cut: PERF.md)
        y = torch.randn((n, DIM + 16), device=dev)
        reduce_ms = time_ms(lambda: mesh.all_reduce_(y))
        del y
        log(f"  the all-reduce of the sharded rsvd's ({n}, {DIM + 16}) "
            f"partial {reduce_ms:.3f} ms; [{card}]")
        assert counted["m_total"] == p7["m_total"], counted["m_total"]
        assert counted["ranges"] == p7["ranges"]
        log(f"  {counted['m_total']} unique pairs, every one of {passes} "
            "count ranges equal to phase 7's (entries, pair sum, weighted "
            "key sum)")
        torch.cuda.empty_cache()

        # ---- (c) Node2Vec over the sharded tables (K18)
        first = next(iter(alg._device_walks2(
            g, N2V_WALKS, WALK_LENGTH, N2V_P, N2V_Q, 0, resident=True,
            walk_tables="sharded", mesh=mesh)))[0]
        assert torch.equal(first.cpu(), n2v_walks)
        log(f"  the first Node2Vec batch {tuple(first.shape)} over the "
            "sharded tables (K18) bitwise equal to phase 8's (K12)")
        del first
        n2v_batches = -(-int((deg > 0).sum()) * N2V_WALKS // alg._WALK2_BATCH)
        n2v_passes = alg._cooc_passes(g, N2V_WALKS, WALK_LENGTH, WINDOW)
        want = {"pair_enum": n2v_batches,
                "run_length": n2v_batches,
                "run_length_merge": (n2v_batches - 1) * n2v_passes,
                "ppmi": n2v_passes, "spmm_axpy": applies * n2v_passes}
        alg.device_pair_counts = counts
        try:
            n2v_launches = staged_spectral(
                "embed_node2vec(sharded tables, n_devices=1)",
                lambda: alg.embed_node2vec(
                    g, feature_dim=DIM, num_walks=N2V_WALKS,
                    walk_length=WALK_LENGTH, window_size=WINDOW, p=N2V_P,
                    q=N2V_Q, backend="device", cooccurrence="device",
                    factorization="device", n_devices=1,
                    walk_tables="sharded"),
                None, (walk, "walk_p_q_sharded"), (cooccur, "pair_keys"),
                (torch, "sort"), (cooccur, "run_length"),
                (cooccur, "ppmi_values"), (dense, "spmm_accumulate_"),
                (cooccur, "_merge"), (torch.linalg, "qr"),
                (torch.linalg, "svd"), (alg, "_finalize_factor"))
        finally:
            alg.device_pair_counts = real_counts
        assert counted["pairs"] == N2V_PAIRS, counted["pairs"]
        # one slice: K18's local stage once a hop, nothing else
        want["walk2_owned"] = n2v_batches * (WALK_LENGTH - 1)
        rest = {k: v for k, v in n2v_launches.items() if v}
        assert rest == want, (rest, want)
        log(f"  {counted['pairs']} Node2Vec pairs (phase 8's count), "
            f"{counted['m_total']} unique; K18 launches "
            f"{n2v_launches['walk2_owned']} ({n2v_batches} batches of "
            f"{WALK_LENGTH - 1} hops, one local stage a hop)")
        torch.cuda.empty_cache()

        # ---- (d) K17 and K18 at the main path's shapes, timed
        indptr, cols, deg_, _ = alg._walk_csr(g)
        t1 = rank_slices((indptr, cols, deg_), n, 1, dev)
        starts = p7["walks"][:, 0].contiguous().to(dev)
        k17 = lambda: walk.walk_uniform_sharded(t1, starts, WALK_LENGTH, 0, 0)
        walks = k17()
        assert torch.equal(walks.cpu(), p7["walks"])
        k17_ms = time_ms(k17)
        with plain_walk_kernels():
            assert torch.equal(k17(), walks)
            k17_plain_ms = time_ms(k17, reps=3, warmup=1)
        k17_bytes = k17_sector_bytes(walks, t1[0].deg, n)
        log(f"K17 ({walks.shape[0]} walks of {WALK_LENGTH}, "
            f"{WALK_LENGTH - 1} launches) {k17_ms:.3f} ms (plain "
            f"{k17_plain_ms:.3f}; K8 on the same walks {p7['k8_ms']:.3f}); "
            f"bound {k17_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes, "
            f"32-byte sectors); [{card}]")
        del walks, t1, starts
        arrays = alg._walk_csr(g, with_vals=True)
        starts = n2v_walks[:, 0].contiguous().to(dev)
        tries = walk.walk2_tries(N2V_Q)
        k18_args = (K18_TIMED_LENGTH, float(np.float32(1.0 / N2V_P)),
                    float(np.float32(1.0 / N2V_Q)), tries, 0, 0)
        k18_ms, k18_hop_launches = {}, {}
        for world in (1, 4):
            tw = rank_slices(arrays[:3] + arrays[4:], n, world, dev)
            k18 = lambda: walk.walk_p_q_sharded(tw, starts, *k18_args)
            walks = k18()
            assert torch.equal(walks.cpu(), n2v_walks[:, :K18_TIMED_LENGTH])
            before = kernels.LAUNCHES["walk2_owned"]
            k18_ms[world] = time_ms(k18)
            k18_hop_launches[world] = (kernels.LAUNCHES["walk2_owned"]
                                       - before) / (12 * (K18_TIMED_LENGTH
                                                          - 1))
            if world == 1:
                with plain_walk_kernels():
                    k18_plain, k18_plain_ms = timed_once(k18)
                assert torch.equal(k18_plain, walks)
                del k18_plain
            del tw
        t12 = walk.WalkTables2(*arrays[:3], n, *arrays[4:], dev)
        k12_ms = time_ms(lambda: walk.walk_p_q(
            t12.indptr, t12.cols, t12.vals, t12.deg, t12.wmax, t12.wsum,
            starts, *k18_args[:4], 0, 0, n))
        k18_bytes = k12_sector_bytes(walks, t12)
        log(f"K18 ({walks.shape[0]} walks of {K18_TIMED_LENGTH}): one slice "
            f"{k18_ms[1]:.3f} ms ({k18_hop_launches[1]:.2f} launches a hop; "
            f"plain {k18_plain_ms:.3f}), four slices summed in this process "
            f"{k18_ms[4]:.3f} ms ({k18_hop_launches[4]:.2f} launches a hop, "
            f"chunks of {walk.WALK2_CHUNK} rounds); K12 on the same walks "
            f"{k12_ms:.3f}; bound {k18_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
            f"(bytes, 32-byte sectors); [{card}]")
        del walks, t12, starts

        # ---- (e) the row-sharded retrieval index against the unsharded
        qrows = np.random.default_rng(5).choice(table.shape[0], QUERIES,
                                                replace=False)
        one = ShardedDeviceIndex(big, table, device=dev)
        want_nb = one.query_batch(table[qrows], top_k=TOP_K)
        sharded = ShardedDeviceIndex(big, table, mesh=mesh)
        t0 = time.perf_counter()
        got_nb = sharded.query_batch(table[qrows], top_k=TOP_K)
        query_s = time.perf_counter() - t0
        tied = same_neighbours(got_nb, want_nb)
        eid = big.entity_ids[int(qrows[0])]
        tied += same_neighbours([sharded.query(eid, top_k=TOP_K)],
                                [one.query(eid, top_k=TOP_K)])
        log(f"  ShardedDeviceIndex(mesh=) over ({table.shape[0]}, "
            f"{table.shape[1]}): {QUERIES} queries at top_k={TOP_K} in "
            f"{query_s * 1e3:.3f} ms (host clock, with the result dicts), "
            f"scores equal to the unsharded index's, indices equal but for "
            f"{tied} lists that differ only on exact ties (and query() of "
            f"one entity the same); [{card}]")
        del sharded, one

    src = "cleora_tpu_torch/kernels/"
    return [
        kernel_row("walk_owned", src + "walk_owned.cu",
                   "cleora_tpu/algorithms.py:1380", k17_ms, k17_plain_ms,
                   None, 0.0, k17_bytes, 0, launches["walk_owned"]),
        kernel_row("walk2_owned", src + "walk2_owned.cu",
                   "cleora_tpu/algorithms.py:1574", k18_ms[1], k18_plain_ms,
                   None, 0.0, k18_bytes, 0, n2v_launches["walk2_owned"]),
    ]


# ------------------------------- phase 14: the overlapped and hier exchanges
def round_tensors(rc, dev: torch.device) -> tuple:
    """A RoundCsr's arrays on the card: (row_ids, indptr, cols, vals)."""
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (rc.row_ids, rc.indptr, rc.cols, rc.vals))


def round_bytes(rc, itemsize: int, width: int, mode: str = "old",
                rps: int = 0) -> int:
    """K19's bound for one round: its inputs read once, its outputs written
    once.  ``"old"``: the compact CSR (row ids, row pointer, edges), each
    distinct table row it names, and each accumulator row it updates read
    and written (the design before the views; a middle round, ``"middle"``,
    still moves that).  ``"first"``: a view of every one of the ``rps``
    rows (row pointer only), the edges and table rows, the rows written and
    no accumulator read.  ``"last"``: the same, with every accumulator row
    read (the normalisation needs them all).  ``"only"``: one shard's
    single round, as ``"first"``."""
    distinct = int(np.unique(rc.cols).shape[0])
    r = int(rc.row_ids.shape[0])
    gather = 8 * int(rc.cols.shape[0]) + distinct * width * itemsize
    if mode in ("old", "middle"):
        return 4 * r + 8 * (r + 1) + gather + 2 * r * width * 4
    rows = rps * width * 4
    return 8 * (rps + 1) + gather + (2 * rows if mode == "last" else rows)


def round_library(rc, n_rows: int, n_table: int, dev: torch.device):
    """The round as a (n_rows, n_table) torch sparse CSR for the library
    yardstick: torch.sparse.mm of it, then add_ into the accumulator."""
    counts = np.zeros(n_rows, dtype=np.int64)
    counts[rc.row_ids] = np.diff(rc.indptr)
    crow = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=crow[1:])
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow).to(dev),
        torch.from_numpy(rc.cols.astype(np.int64)).to(dev),
        torch.from_numpy(rc.vals).to(dev), size=(n_rows, n_table))


TRACE_SPAN = "phase14_embed_iteration"


def traced_embed_iteration() -> tuple:
    """tracing.trace() around one embed() iteration and a two-iteration
    embed_with_attention() on phase 4's graph, with an annotate() span:
    (span found, the port's launches as tracing.port_launches gives them,
    the device kernels, event count).  The profiler's own records can
    lose the port's kernels late in a long process (PERF.md §7); trace()
    writes those launches from their CUDA event pairs."""
    import tempfile

    import cleora_tpu_torch as ctt
    from cleora_tpu_torch.tracing import (
        annotate,
        kernel_events,
        port_launches,
        trace,
    )

    g = random_graph(PARITY_NODES, PARITY_EDGES, seed=3)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            with annotate(TRACE_SPAN):
                ctt.embed(g, feature_dim=DIM, num_iterations=1)
                ctt.embed_with_attention(g, feature_dim=DIM,
                                         num_iterations=2)
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    return (any(e.get("name") == TRACE_SPAN for e in events),
            port_launches(events), len(kernel_events(events)), len(events))


def halo_exchanges(dev: torch.device, card: str, big, table: np.ndarray,
                   p11: dict, walk_graph, walk_modes: list) -> list:
    """Phase 14: the overlapped and hierarchical halo exchanges (K16, K19,
    P2P rounds, the two-level collectives) at full width on phase 5's
    graph and output, as main paths in a one-rank NCCL group; tracing,
    the capacity plan and the scaling report on the card."""
    import cleora_tpu_torch as ctt
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.halo import halo_pack, halo_pack_plain
    from cleora_tpu_torch.ops.spmm import (
        CsrMatrix,
        spmm,
        spmm_acc_plain,
    )
    from cleora_tpu_torch.parallel import embed_sharded, make_hier_mesh
    from cleora_tpu_torch.parallel.embed import (
        overlap_modes,
        overlap_round,
        overlap_views,
    )
    from cleora_tpu_torch.parallel.shard import (
        RoundCsr,
        plan_halo_hier,
        plan_overlap,
    )
    from cleora_tpu_torch.plan import format_plan, plan_report
    from cleora_tpu_torch.tracing import device_memory_stats

    sharded, plan, out_b = p11["sharded"], p11["plan"], p11["out_b"]
    n = big.num_entities
    rps, P = sharded.rows_per_shard, sharded.n_shards
    padded = np.zeros((sharded.n_rows_padded, DIM), dtype=np.float32)
    padded[:n] = table
    blocks = [torch.from_numpy(padded[k * rps:(k + 1) * rps]).to(dev)
              for k in range(P)]
    del padded

    # ---- (a) shard 0 of the 4-way overlap plan: each round's slab packed
    # by K16 from its owner's rows here, accumulated by K19
    t0 = time.perf_counter()
    oplan = plan_overlap(sharded, halo=plan)
    plan_s = time.perf_counter() - t0
    M = oplan.M
    rounds = oplan.rounds[0]
    slab_of = {r: (-r) % P for r in range(P)}  # round r: shard (0 - r) mod P
    sends = {r: torch.from_numpy(np.ascontiguousarray(
        oplan.send_idx[slab_of[r], 0][None])).to(dev) for r in range(1, P)}

    def tables(dtype):
        out = {0: blocks[0].to(dtype)}
        for r in range(1, P):
            out[r] = halo_pack(blocks[slab_of[r]].to(dtype),
                               sends[r]).view(M, DIM)
        return out

    log(f"phase 14 (a), shard 0 of plan_overlap(shard_graph(graph, {P})) "
        f"({rps} rows a shard, M={M}, planned in {plan_s:.3f} s on the host "
        "from phase 11's plan_halo): rounds of "
        + ", ".join(f"{rc.row_ids.shape[0]} rows / {rc.cols.shape[0]} edges"
                    for rc in rounds))
    views = overlap_views(rounds, rps, dev)
    acc_total = torch.empty((rps, DIM), device=dev)
    k19_round_ms = []
    for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-6)),
                       (torch.bfloat16, dict(rtol=1e-5, atol=1e-6))):
        tabs = tables(dtype)
        own = blocks[0].to(dtype)
        acc = torch.randn((rps, DIM), device=dev)
        for r in range(P):
            # each round in its mode, with a residual mix and l2 in the
            # last, against the plain version on the same accumulator
            want = spmm_acc_plain(acc.clone(), *views[r][:4], tabs[r],
                                  **overlap_modes(r, P, own, 0.3, "l2"))
            overlap_round(acc, views, r, tabs[r], own, 0.3, "l2")
            torch.cuda.synchronize()
            torch.testing.assert_close(acc, want, **tol)
            if dtype == torch.float32:
                overlap_round(acc_total, views, r, tabs[r], own, 0.0, "l2")
        del tabs, want, acc, own
    # the four rounds' sum against K1 over shard 0's halo-remapped CSR
    lr = sharded.local_rows[0]
    indptr = np.zeros(rps + 1, dtype=np.int64)
    np.cumsum(np.bincount(lr, minlength=rps), out=indptr[1:])
    halo_csr = CsrMatrix(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in (indptr, plan.remapped_cols[0],
                                     sharded.vals[0])))
    recv = torch.cat([halo_pack(blocks[k], torch.from_numpy(
        np.ascontiguousarray(plan.send_idx[k, 0][None])).to(dev)).view(M, DIM)
        for k in range(P)])
    k1 = spmm(halo_csr, recv, normalization="l2")
    sum_err = max_err(acc_total, k1)
    log(f"  K19 against spmm_acc_plain in float32 and bfloat16 on every "
        f"round in its mode (round 0 written over every row, rounds 1-2 "
        f"added over their compact rows, round 3 added over every row with "
        f"a residual mix of 0.3 and l2; rtol=1e-5, atol=1e-6); the four "
        f"rounds (l2 in the last) against K1 with l2 fused over shard 0's "
        f"halo-remapped CSR on the same slabs: max |diff| {sum_err:.3e}")
    assert sum_err <= 1e-5, sum_err
    del recv, k1, halo_csr
    tabs = tables(torch.float32)
    scratch = torch.zeros((rps, DIM), device=dev)
    step_plain_ms = step_lib_ms = step_bytes = step_old_bytes = 0.0
    for r, rc in enumerate(rounds):
        mode = "first" if r == 0 else "last" if r == P - 1 else "middle"
        modes = overlap_modes(r, P, blocks[0], 0.0, "l2")
        ms = time_ms(lambda: overlap_round(scratch, views, r, tabs[r],
                                           blocks[0], 0.0, "l2"))
        plain = time_ms(lambda: spmm_acc_plain(scratch, *views[r][:4],
                                               tabs[r], **modes),
                        reps=3, warmup=1)
        S = round_library(rc, rps, tabs[r].shape[0], dev)
        lib = time_ms(lambda: scratch.add_(torch.sparse.mm(S, tabs[r])))
        nbytes = round_bytes(rc, 4, DIM, mode, rps)
        old_bytes = round_bytes(rc, 4, DIM)
        k19_round_ms.append(ms)
        step_plain_ms += plain
        step_lib_ms += lib
        step_bytes += nbytes
        step_old_bytes += old_bytes
        log(f"  K19 round {r} ({mode}: {rc.row_ids.shape[0]} rows with "
            f"edges, {rc.cols.shape[0]} edges, table {tabs[r].shape[0]} "
            f"rows): {ms:.3f} ms (plain {plain:.3f}, torch.sparse.mm + add_ "
            f"{lib:.3f}); bound {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
            f"(bytes; the old design's count "
            f"{old_bytes / HBM_BYTES_PER_S * 1e3:.3f}); [{card}]")
        del S
    pack_ms = sum(time_ms(lambda r=r: halo_pack(blocks[slab_of[r]],
                                                sends[r]))
                  for r in range(1, P))
    pack_plain = sum(time_ms(lambda r=r: halo_pack_plain(blocks[slab_of[r]],
                                                         sends[r]))
                     for r in range(1, P))
    pack_lib = sum(time_ms(lambda r=r: blocks[slab_of[r]].index_select(
        0, sends[r].flatten())) for r in range(1, P))
    pack_bytes = sum(4 * int(torch.unique(sends[r]).numel()) * DIM
                     + 4 * M * DIM + 4 * M for r in range(1, P))

    def overlap_step():
        acc = torch.empty((rps, DIM), device=dev)
        for r in range(P):
            tab = blocks[0] if r == 0 else halo_pack(
                blocks[slab_of[r]], sends[r]).view(M, DIM)
            overlap_round(acc, views, r, tab, blocks[0], 0.0, "l2")
        return acc

    step_ms = time_ms(overlap_step)
    log(f"  shard 0's overlap step in one process ({P - 1} K16 packs + {P} "
        f"K19 rounds, l2 in the last, no transfers): {step_ms:.3f} ms; the "
        f"packs alone {pack_ms:.3f} ms (plain {pack_plain:.3f}, "
        f"index_select {pack_lib:.3f}); the rounds' bound "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (the old design's "
        f"count, without its zero fill and K2: "
        f"{step_old_bytes / HBM_BYTES_PER_S * 1e3:.3f}); [{card}]")
    del tabs, scratch, views, acc_total

    # ---- (c) K16 over shard 0's slabs of the 2x2 hierarchical plan
    t0 = time.perf_counter()
    hplan = plan_halo_hier(sharded, 2, 2)
    hplan_s = time.perf_counter() - t0
    hier_sends = [torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)
                  for a in (hplan.send_intra, hplan.send_cross)]
    for dtype in (torch.float32, torch.bfloat16):
        x = blocks[0].to(dtype)
        for s in hier_sends:
            got = halo_pack(x, s)
            torch.cuda.synchronize()
            assert torch.equal(got, halo_pack_plain(x, s)), dtype
    del x, got
    hier_ms = sum(time_ms(lambda s=s: halo_pack(blocks[0], s))
                  for s in hier_sends)
    hier_plain = sum(time_ms(lambda s=s: halo_pack_plain(blocks[0], s))
                     for s in hier_sends)
    hier_lib = sum(time_ms(lambda s=s: blocks[0].index_select(
        0, s.flatten())) for s in hier_sends)
    hier_bytes = sum(4 * int(torch.unique(s).numel()) * DIM
                     + 4 * s.numel() * DIM + 4 * s.numel()
                     for s in hier_sends)
    log(f"  (c) K16 over shard 0's send_intra {tuple(hier_sends[0].shape)} "
        f"and send_cross {tuple(hier_sends[1].shape)} of plan_halo_hier(.., "
        f"2, 2) (Mc={hplan.Mc}, Mh={hplan.Mh}, table {hplan.table_rows} "
        f"rows; planned in {hplan_s:.3f} s): bitwise equal to plain in "
        f"float32 and bfloat16; {hier_ms:.3f} ms for both (plain "
        f"{hier_plain:.3f}, index_select {hier_lib:.3f}); bound "
        f"{hier_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; [{card}]")
    del blocks, hier_sends, hplan, oplan, sends

    # ---- (b) both modes as main paths in a one-rank NCCL group
    kw = dict(feature_dim=DIM, num_iterations=ITERATIONS, whiten=True)
    none = dict.fromkeys(kernels.LAUNCHES, 0)
    rows = sample_rows(n)
    with one_rank_nccl_group():
        out_o, o_launches = run_main_path(
            "  (b) embed_sharded(halo=\"overlap\"), one-rank NCCL group",
            lambda: embed_sharded(big, halo="overlap", **kw))
        # one K19 launch a step, the normalisation in its epilogue: no K2
        assert o_launches == none | {"spmm_acc": ITERATIONS,
                                     "hash_init": 1}, o_launches
        if out_o.tobytes() == out_b.tobytes():
            log("  overlap: bitwise equal to phase 11 (b)")
        else:
            err, top = gram_err(out_o, out_b, rows)
            log(f"  overlap: Gram of {len(rows)} rows against phase 11 (b) "
                f"max |diff| {err:.3e} (entries up to {top:.1f}); raw max "
                f"|diff| {float(np.abs(out_o - out_b).max()):.3e}")
            assert err <= 2e-5, err
        check_covariance(out_o, dev)
        del out_o
        mesh = make_hier_mesh(1, 1)
        out_h, h_launches = run_main_path(
            "  (b) embed_sharded(halo=\"hier\", mesh=make_hier_mesh(1, 1)), "
            "one-rank NCCL group",
            lambda: embed_sharded(big, halo="hier", mesh=mesh, **kw))
        assert h_launches == none | {"spmm_csr": ITERATIONS,
                                     "hash_init": 1,
                                     "halo_pack": 2 * ITERATIONS}, h_launches
        assert out_h.tobytes() == out_b.tobytes()
        log("  hier: bitwise equal to phase 11 (b)")
        del out_h, mesh

    # ---- K19 at the main path's shape: one shard's step, round 0 over
    # every edge and every row, written and normalised in one launch
    ds = big.data
    deg = np.diff(ds.indptr)
    rc0 = RoundCsr.from_edges(np.repeat(np.arange(n, dtype=np.int32), deg),
                              ds.indices, ds.left_vals)
    (view,) = overlap_views([rc0], n, dev)
    csr = CsrMatrix.from_numpy(ds.indptr, ds.indices, ds.left_vals, dev)
    x = torch.from_numpy(table).to(dev)
    acc = torch.empty((n, DIM), device=dev)
    modes = overlap_modes(0, 1, x, 0.0, "l2")
    got = overlap_round(acc, [view], 0, x, x, 0.0, "l2").clone()
    want = spmm_acc_plain(torch.empty_like(acc), *view[:4], x, **modes)
    k1 = spmm(csr, x, normalization="l2")
    torch.cuda.synchronize()
    k19_err = max_err(got, want)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, k1), max_err(got, k1)
    del got, want, k1
    k19_ms = time_ms(lambda: overlap_round(acc, [view], 0, x, x, 0.0, "l2"))
    k1_ms = time_ms(lambda: spmm(csr, x, normalization="l2"))
    k19_plain_ms = time_ms(lambda: spmm_acc_plain(acc, *view[:4], x,
                                                  **modes), reps=3, warmup=1)
    S = round_library(rc0, n, n, dev)
    k19_lib_ms = time_ms(lambda: torch.sparse.mm(S, x))
    k19_bytes = round_bytes(rc0, 4, DIM, "only", n)
    log(f"  K19 at the main path's shape (one shard's step: round 0 over "
        f"{n} rows, {rc0.cols.shape[0]} edges, D={DIM}, written and l2 "
        f"normalised in one launch): {k19_ms:.3f} ms, bitwise K1 with l2 "
        f"fused on the same graph ({k1_ms:.3f} ms; plain {k19_plain_ms:.3f}, "
        f"torch.sparse.mm without the normalisation {k19_lib_ms:.3f}); bound "
        f"{k19_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes; the old "
        f"design's count for its compact round "
        f"{round_bytes(rc0, 4, DIM) / HBM_BYTES_PER_S * 1e3:.3f}, before its "
        f"zero fill and K2); max |diff| against plain {k19_err:.3e}; "
        f"[{card}]")
    del S, view, csr, x, acc
    # ---- (d) tracing: one embed() iteration on phase 4's graph
    import tempfile

    span, launches, n_kernels, n_events = traced_embed_iteration()
    assert span, "the trace lacks the annotate() span"
    names = [name for name, _ in launches]
    counts = {name: names.count(name) for name in set(names)}
    # embed(): K3 and K1; embed_with_attention(): K3, K1, the fused pass
    assert counts == {"spmm_csr": 2, "attention_spmm": 1, "hash_init": 2}, \
        launches
    lost = [name for name, source in launches if source == "events"]
    here = ", ".join(f"{name} {counts[name]}"
                     for name in ("spmm_csr", "attention_spmm", "hash_init"))
    stats = device_memory_stats()
    assert stats[0]["bytes_limit"] == torch.cuda.mem_get_info(0)[1]
    log(f"  (d) trace() of one embed() iteration and a two-iteration "
        f"embed_with_attention() after {PROFILER_SESSIONS[0]} earlier "
        f"profiler sessions in this process: {n_events} events, "
        f"{n_kernels} device kernels; the port's launches {here}, of them "
        f"{len(lost)} lost by the profiler and written from event pairs "
        f"{lost} (the annotate() span named); device_memory_stats(): "
        f"{stats[0]}")

    # ---- (e) the capacity plan
    rep = plan_report(big, feature_dim=DIM)
    assert rep["embed"][0]["fits"], rep["embed"]
    log("  (e) plan_report(phase 5's graph):\n    "
        + format_plan(rep).replace("\n", "\n    "))
    rep = plan_report(walk_graph, feature_dim=DIM, walks=True,
                      num_walks=WALKS_PER_NODE, walk_length=WALK_LENGTH,
                      window_size=WINDOW)
    assert walk_modes and set(walk_modes) == {rep["walks"]["table_mode"]}, \
        (walk_modes, rep["walks"])
    log(f"  plan_report(phase 7's corpus, walks=True): table mode "
        f"{rep['walks']['table_mode']!r}, as phase 7 chose; "
        f"{rep['walks']['counting_passes']} counting passes, worst case "
        f"{rep['walks']['worst_case_pairs']} pairs")

    # ---- (f) the scaling report through the CLI, its ranks on the card
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scaling.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cleora_tpu_torch", "scaling", "--json",
             path], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        with open(path) as f:
            scaling = json.load(f)
    res = scaling["results"]
    assert [r["devices"] for r in res] == list(
        c for c in (1, 2, 4, 8) if c <= torch.cuda.device_count())
    log(f"  (f) `python -m cleora_tpu_torch scaling`: "
        + "; ".join(f"{r['devices']} rank(s) {r['edges_per_s']:.4e} edges/s, "
                    f"efficiency {r['efficiency']:.3f}" for r in res)
        + f" ({time.perf_counter() - t0:.1f} s with its processes); [{card}]")

    src = "cleora_tpu_torch/"
    return [
        kernel_row("spmm_acc", src + "kernels/spmm_acc.cu",
                   "cleora_tpu/parallel/embed.py:49", k19_ms, k19_plain_ms,
                   k19_lib_ms, k19_err, k19_bytes, 2 * rc0.cols.shape[0] * DIM,
                   o_launches["spmm_acc"]),
        kernel_row("overlap_propagate", src + "parallel/embed.py",
                   "cleora_tpu/parallel/embed.py:42", step_ms,
                   step_plain_ms + pack_plain, step_lib_ms + pack_lib,
                   sum_err, step_bytes + pack_bytes,
                   2 * sum(rc.cols.shape[0] for rc in rounds) * DIM,
                   o_launches["spmm_acc"]),
        kernel_row("hier_exchange", src + "parallel/embed.py",
                   "cleora_tpu/parallel/embed.py:97", hier_ms, hier_plain,
                   hier_lib, 0.0, hier_bytes, 0, h_launches["halo_pack"]),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cleora_tpu_torch.algorithms as alg

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = environment()
    build_kernels()
    check_kernels(dev)
    slice_parity(dev)
    walk_parity(dev)
    rows, graph, table = full_width(dev, card)
    spectral_rows, spectral_refs = spectral_full_width(dev, card, graph)
    rows += spectral_rows
    graph._device_cache.clear()  # phase 9 reads its entity ids only
    with recorded(alg, "_walk_table_mode") as walk_modes:
        walk_rows, walk_graph, walk_refs = walk_full_width(dev, card)
    rows += walk_rows
    t0 = time.perf_counter()
    n2v_rows, gq, emb_q, n2v_walks = node2vec_full_width(dev, card,
                                                         walk_graph)
    rows += n2v_rows
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows += retrieval_full_width(dev, card, graph, table, gq, emb_q)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    del gq, emb_q
    t0 = time.perf_counter()
    arxiv, nc_rows = node_classification(dev, card, graph)
    rows += nc_rows
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    p11_rows, p11 = streamed_sharded(dev, card, graph, table, arxiv)
    rows += p11_rows
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    del arxiv
    t0 = time.perf_counter()
    rows += sharded_siblings(dev, card, graph, spectral_refs)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    del spectral_refs
    t0 = time.perf_counter()
    rows += walk_siblings_sharded(dev, card, walk_graph, walk_refs,
                                  n2v_walks, graph, table)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    del walk_refs, n2v_walks
    t0 = time.perf_counter()
    rows += halo_exchanges(dev, card, graph, table, p11, walk_graph,
                           walk_modes)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    del walk_graph, table, p11
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
