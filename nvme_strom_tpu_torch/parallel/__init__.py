"""Ring-parallel paths: sharded loading, the multi-host loader, the ring
permute (B4), all-gather and the ring multi-query scan."""

from .mesh import RingMesh, RingSharding, ShardedTensor, make_scan_mesh
from .ring import (make_ring_multi_query_scan, permute_backend,
                   ring_all_gather, ring_permute_step, ring_scan_source)
from .shardload import load_pages_multihost, shard_ownership
from .stream import (ShardedBatchStream, distributed_scan_filter,
                     load_pages_sharded)

__all__ = ["RingMesh", "RingSharding", "ShardedTensor", "make_scan_mesh", "make_ring_multi_query_scan",
           "ring_scan_source", "load_pages_sharded", "load_pages_multihost",
           "shard_ownership", "permute_backend", "ring_permute_step",
           "ring_all_gather", "ShardedBatchStream",
           "distributed_scan_filter"]
