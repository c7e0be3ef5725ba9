"""Mesh-parallel paths: sharded loading, the multi-host loader, the ring
permute (B4), all-gather and the ring multi-query scan, the distributed
scan step with its column lanes, the bucket exchange, the sample sort and
the partitioned join."""

from .dscan import make_distributed_scan_step, shard_pages
from .mesh import (RingMesh, RingSharding, ShardedTensor, make_scan_mesh,
                   pages_sharding)
from .ring import (make_ring_multi_query_scan, permute_backend,
                   ring_all_gather, ring_permute_step, ring_scan_source)
from .shardload import load_pages_multihost, shard_ownership
from .sort import make_distributed_distinct, make_distributed_sort
from .stream import (ShardedBatchStream, distributed_scan_filter,
                     load_pages_sharded)

__all__ = ["make_distributed_scan_step", "shard_pages", "RingMesh",
           "RingSharding", "ShardedTensor", "make_scan_mesh",
           "pages_sharding", "make_ring_multi_query_scan",
           "make_distributed_sort", "make_distributed_distinct",
           "ring_scan_source", "load_pages_sharded", "load_pages_multihost",
           "shard_ownership", "permute_backend", "ring_permute_step",
           "ring_all_gather", "ShardedBatchStream",
           "distributed_scan_filter"]
