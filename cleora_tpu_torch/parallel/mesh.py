"""The process-group counterpart of the JAX package's 1-D device mesh.

The JAX package shards the embedding rows over one mesh axis of devices
(cleora_tpu/parallel/mesh.py), or over a ("host", "chip") grid for the
hierarchical exchange.  Here a shard is a process: rank k of a
``torch.distributed`` group owns rows [k·rps, (k+1)·rps) on its own device,
one card per rank (NCCL) or the CPU (gloo).  :class:`ShardGroup` carries the
rank, the world size, the device and the group, and runs the collectives
of the loop and of the sharded siblings.  Without an initialized group the
calling process is the one shard and the collectives are identities.
:func:`make_hier_mesh` adds the grid: host-major ranks and the two
subgroups of the chip and host axes.
"""

from __future__ import annotations

import dataclasses
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
    # the ("host", "chip") grid of make_hier_mesh: rank = host·C + chip;
    # chip_group holds the ranks of my host, host_group the ranks with my
    # chip index on every host (None without a process group)
    n_hosts: Optional[int] = None
    chips_per_host: Optional[int] = None
    chip_group: Optional[object] = None
    host_group: Optional[object] = None

    @property
    def is_hier(self) -> bool:
        """Whether :func:`make_hier_mesh` made this group."""
        return self.n_hosts is not None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the shards, in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every shard, in place."""
        if self.group is not None:
            dist.broadcast(t, src, group=self.group)
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

    def sub_all_to_all_(self, recv: torch.Tensor, send: torch.Tensor,
                        axis: str) -> torch.Tensor:
        """:meth:`all_to_all` over the ``"chip"`` or ``"host"`` subgroup,
        into ``recv`` (contiguous, ``send``'s shape).  Returns ``recv``."""
        group = self._axis_group(axis)
        if group is None:
            recv.copy_(send)
        else:
            dist.all_to_all_single(recv, send.contiguous(), group=group)
        return recv

    def sub_all_gather_(self, out: torch.Tensor, t: torch.Tensor,
                        axis: str) -> torch.Tensor:
        """Every member's ``t`` of the ``axis`` subgroup stacked along dim
        0 in its rank order, into ``out`` (contiguous).  Returns ``out``."""
        group = self._axis_group(axis)
        if group is None:
            out.copy_(t.reshape(out.shape))
        else:
            dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out

    def _axis_group(self, axis: str):
        if axis not in ("chip", "host"):
            raise ValueError(f"unknown mesh axis {axis!r}")
        if not self.is_hier:  # one shard: both axes are the whole group
            return self.group
        return self.chip_group if axis == "chip" else self.host_group

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


def make_hier_mesh(n_hosts: Optional[int] = None,
                   chips_per_host: Optional[int] = None,
                   device=None) -> ShardGroup:
    """The shard of the calling process on a ("host", "chip") grid, for
    ``embed_sharded(halo="hier")`` (cleora_tpu/parallel/mesh.py:
    make_hier_mesh).  Ranks are host-major, ``rank = host·C + chip``, which
    is torchrun's ``RANK = node_rank·nproc_per_node + local_rank``.
    Defaults: ``chips_per_host`` = ``LOCAL_WORLD_SIZE`` (else the world
    size), ``n_hosts`` = world size / chips_per_host.  Every rank must call
    it, in the same order as its other group calls: each rank takes part
    in creating every subgroup.  Without a process group it is the 1×1
    grid, whose collectives are identities."""
    base = make_mesh(None, device)
    world = base.world_size
    if chips_per_host is None:
        if n_hosts is not None:
            chips_per_host = max(1, world // max(1, int(n_hosts)))
        else:
            chips_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    C = int(chips_per_host)
    H = int(n_hosts) if n_hosts is not None else world // max(1, C)
    if H < 1 or C < 1 or H * C != world:
        raise ValueError(
            f"a {H}x{C} (host, chip) mesh needs {H * C} ranks, but the "
            f"process group has {world}"
        )
    chip_group = host_group = None
    if base.group is not None:
        chip_group, _ = dist.new_subgroups_by_enumeration(
            [[h * C + c for c in range(C)] for h in range(H)])
        host_group, _ = dist.new_subgroups_by_enumeration(
            [[h * C + c for h in range(H)] for c in range(C)])
    return dataclasses.replace(base, n_hosts=H, chips_per_host=C,
                               chip_group=chip_group, host_group=host_group)
