"""The sharded embed loop: rows partitioned over the ranks of a
``torch.distributed`` process group, one card per rank (the port of
cleora_tpu/parallel).  Without a group the calling process is the one
shard, which is how ``embed(DiskGraph)`` runs on one card.  The
exchange is the all-gather, the halo ``all_to_all``, its pipelined
point-to-point rounds (``halo="overlap"``) or its two-level form on a
:func:`make_hier_mesh` grid (``halo="hier"``).  The spectral
siblings over the group are in :mod:`.algorithms`; the walk pipeline's
sharded factorization is :mod:`.cooccur`."""

from .cooccur import home_ranges, sharded_counts_to_embeddings
from .distributed import init_distributed
from .embed import build_sharded_embed, embed_sharded
from .mesh import ShardGroup, make_hier_mesh, make_mesh
from .shard import (
    HaloPlan,
    HierHaloPlan,
    OverlapPlan,
    ShardedCoo,
    ShardedCsr,
    pad_rows,
    plan_halo,
    plan_halo_hier,
    plan_overlap,
    shard_coo,
    shard_csr,
    shard_graph,
)
from .state import EmbeddingShards, ShardedCheckpoint

__all__ = [
    "ShardGroup", "make_mesh", "make_hier_mesh", "init_distributed",
    "ShardedCoo", "ShardedCsr", "HaloPlan", "OverlapPlan", "HierHaloPlan",
    "shard_coo", "shard_graph", "shard_csr", "plan_halo", "plan_overlap",
    "plan_halo_hier", "pad_rows",
    "embed_sharded", "build_sharded_embed",
    "EmbeddingShards", "ShardedCheckpoint",
    "home_ranges", "sharded_counts_to_embeddings",
]
