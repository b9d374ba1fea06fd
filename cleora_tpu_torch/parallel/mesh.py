"""The process-group counterpart of the JAX package's 1-D device mesh.

The JAX package shards the embedding rows over one mesh axis of devices
(cleora_tpu/parallel/mesh.py).  Here a shard is a process: rank k of a
``torch.distributed`` group owns rows [k·rps, (k+1)·rps) on its own device,
one card per rank (NCCL) or the CPU (gloo).  :class:`ShardGroup` carries the
rank, the world size, the device and the group, and runs the loop's four
collectives.  Without an initialized group the calling process is the one
shard and the collectives are identities.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .._util import resolve_device


@dataclass(frozen=True)
class ShardGroup:
    """One shard of the row partition: ``rank`` of ``world_size`` on
    ``device``.  ``group`` is None when no process group is initialized
    (one shard in this process)."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[object] = None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the shards, in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every shard's ``t`` stacked along dim 0 in rank order."""
        if self.group is None:
            return t
        out = t.new_empty((self.world_size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """Slab p of ``send`` (dim 0) goes to rank p; slab p of the result
        came from rank p."""
        if self.group is None:
            return send
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send.contiguous(), group=self.group)
        return recv

    def barrier(self) -> None:
        """Wait for every shard: one all-reduce on the shard's own device,
        which both backends run without a device hint."""
        if self.group is not None:
            self.all_reduce_(torch.zeros(1, device=self.device))


def make_mesh(n_devices: Optional[int] = None, device=None) -> ShardGroup:
    """The shard of the calling process.

    With an initialized process group every rank is one shard: NCCL ranks
    run on their card (``LOCAL_RANK``, else the current device), gloo ranks
    on the CPU when the caller passes ``device="cpu"`` (``device=None`` is
    CUDA, and a gloo group raises for it), and ``n_devices`` must be None
    or the world size.  Without
    a group the process is the only shard and ``n_devices`` must be None or
    1: a run over N cards is N processes, one card each.
    """
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and int(n_devices) != world:
            raise ValueError(
                f"n_devices={n_devices} but the process group has {world} "
                f"ranks; launch one process per card with torchrun "
                f"--nproc-per-node {n_devices} and call init_distributed()"
            )
        backend = dist.get_backend()
        if device is None and "LOCAL_RANK" in os.environ:
            device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
        dev = resolve_device(device)
        if (backend == "nccl") != (dev.type == "cuda"):
            raise ValueError(
                f"a {backend} process group cannot run shards on {dev}: "
                "CUDA ranks use NCCL, CPU ranks gloo (pass device='cpu')"
            )
        return ShardGroup(dist.get_rank(), world, dev, dist.group.WORLD)
    if n_devices not in (None, 1):
        raise ValueError(
            f"n_devices={n_devices} needs {n_devices} processes, one card "
            f"each: launch with torchrun --nproc-per-node {n_devices} and "
            "call init_distributed() before embedding"
        )
    return ShardGroup(0, 1, resolve_device(device), None)
