"""The sharded embed loop: rows partitioned over the ranks of a
``torch.distributed`` process group, one card per rank (the port of
cleora_tpu/parallel).  Without a group the calling process is the one
shard, which is how ``embed(DiskGraph)`` runs on one card."""

from .distributed import init_distributed
from .embed import build_sharded_embed, embed_sharded
from .mesh import ShardGroup, make_mesh
from .shard import (
    HaloPlan,
    ShardedCoo,
    ShardedCsr,
    pad_rows,
    plan_halo,
    shard_coo,
    shard_csr,
    shard_graph,
)
from .state import EmbeddingShards, ShardedCheckpoint

__all__ = [
    "ShardGroup", "make_mesh", "init_distributed",
    "ShardedCoo", "ShardedCsr", "HaloPlan", "shard_coo", "shard_graph",
    "shard_csr", "plan_halo", "pad_rows",
    "embed_sharded", "build_sharded_embed",
    "EmbeddingShards", "ShardedCheckpoint",
]
