"""The halo exchange's pack step: gather the boundary rows a shard sends.

Reference semantics: ``jnp.take(x_local, send_idx, axis=0)`` in
cleora_tpu/parallel/embed.py:_propagate_local (:138).  Slot ``[p, m]`` of
the (P, M, D) send slab is local row ``send_idx[p, m]`` of the shard's
state; one ``all_to_all_single`` then delivers slab p to shard p.  On CUDA
:func:`halo_pack` launches kernel K16 (``kernels/halo_pack.cu``); on the
CPU it runs :func:`halo_pack_plain`.  The unpack needs no kernel: K1
gathers straight from the received slab through the plan's remapped
column ids.
"""

from __future__ import annotations

import torch

from .. import kernels


def halo_pack_plain(x_local: torch.Tensor,
                    send_idx: torch.Tensor) -> torch.Tensor:
    p, m = send_idx.shape
    return x_local.index_select(0, send_idx.flatten()).view(
        p, m, x_local.shape[1])


def halo_pack(x_local: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """The (P, M, D) send slab in ``x_local``'s dtype."""
    if x_local.is_cuda:
        return kernels.halo_pack(x_local.contiguous(), send_idx)
    return halo_pack_plain(x_local, send_idx)
