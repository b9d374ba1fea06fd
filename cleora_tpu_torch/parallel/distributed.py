"""Multi-process initialization for the sharded embed loop.

Usage on every rank (one process per card):

    torchrun --nproc-per-node 4 my_embed.py

    from cleora_tpu_torch.parallel import init_distributed, embed_sharded

    init_distributed()                        # reads torchrun's environment
    graph = DiskGraph("graph_dir")            # the same input on every rank
    emb = embed_sharded(graph, feature_dim=256)   # full result on every rank

The JAX package's counterpart initializes ``jax.distributed``
(cleora_tpu/parallel/distributed.py); here it is a ``torch.distributed``
process group: NCCL for CUDA ranks, one card per rank, gloo for CPU ranks.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(backend: Optional[str] = None, device=None) -> bool:
    """Initialize the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``).  ``backend`` defaults to NCCL, or gloo with
    ``device="cpu"``; an NCCL rank binds its card ``LOCAL_RANK`` first.
    Returns True when more than one rank runs after the call, False for a
    single process.  An initialized group is left as it is."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        backend = "gloo" if str(device) == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size() > 1
