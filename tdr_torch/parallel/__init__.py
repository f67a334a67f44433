"""The parallel serving layer (from ``tdr/parallel/__init__.py``): one
controller over a mesh of devices, collectives as functions over per-shard
tensors (``tdr_torch.parallel.mesh``)."""

from tdr_torch.parallel.dense import (
    ShardedFlatIndex,
    build_sharded_flat_index,
    sharded_flat_search,
    sharded_flat_search_prf,
    sharded_row_to_doc,
)
from tdr_torch.parallel.mesh import make_mesh, data_sharding, replicated
from tdr_torch.parallel.pipeline import PipelinedCascade
from tdr_torch.parallel.sharded import (
    ShardedSparseIndex,
    build_sharded_index,
    grid_score_topk,
    sharded_score_topk,
    spmd_global_stats,
    dp_score_topk,
)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "PipelinedCascade",
    "ShardedFlatIndex",
    "build_sharded_flat_index",
    "sharded_flat_search",
    "sharded_flat_search_prf",
    "sharded_row_to_doc",
    "ShardedSparseIndex",
    "build_sharded_index",
    "grid_score_topk",
    "sharded_score_topk",
    "spmd_global_stats",
    "dp_score_topk",
]
