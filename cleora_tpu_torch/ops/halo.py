"""The halo exchange's pack step: gather the boundary rows a shard sends.

Reference semantics: ``jnp.take(x_local, send_idx, axis=0)`` in
cleora_tpu/parallel/embed.py:_propagate_local (:138), and its twins in the
overlapped (:57-58) and hierarchical (:104, :106) exchanges.  Slot ``[p, m]`` of
the (P, M, D) send slab is local row ``send_idx[p, m]`` of the shard's
state; one ``all_to_all_single`` then delivers slab p to shard p.  On CUDA
:func:`halo_pack` launches kernel K16 (``kernels/halo_pack.cu``); on the
CPU it runs :func:`halo_pack_plain`.  The unpack needs no kernel: K1
gathers straight from the received slab through the plan's remapped
column ids.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels


def halo_pack_plain(x_local: torch.Tensor, send_idx: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    p, m = send_idx.shape
    if out is None:
        return x_local.index_select(0, send_idx.flatten()).view(
            p, m, x_local.shape[1])
    torch.index_select(x_local, 0, send_idx.flatten(),
                       out=out.view(p * m, x_local.shape[1]))
    return out


def halo_pack(x_local: torch.Tensor, send_idx: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (P, M, D) send slab in ``x_local``'s dtype: written into
    ``out`` when given (a contiguous buffer the caller reuses), else a new
    tensor."""
    if x_local.is_cuda:
        return kernels.halo_pack(x_local.contiguous(), send_idx, out)
    return halo_pack_plain(x_local, send_idx, out)
