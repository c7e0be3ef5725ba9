"""Data-consumer tier: record datasets, device loaders, checkpoints.

The JAX package's data tier over torch tensors: a shuffled training-input
pipeline (:class:`DeviceLoader`) and direct-to-device checkpoint save and
restore, on the same engine primitives (chunk-granular async reads and
writes, merge planning, pinned staging) as the scan path.  Files are the
JAX package's format byte for byte.
"""

from .records import RecordDataset, RecordWriter, write_records
from .loader import DeviceLoader
from .checkpoint import (checkpoint_info, restore_checkpoint, save_checkpoint,
                         save_checkpoint_sharded)

__all__ = [
    "RecordDataset", "RecordWriter", "write_records", "DeviceLoader",
    "save_checkpoint", "save_checkpoint_sharded", "restore_checkpoint",
    "checkpoint_info",
]
