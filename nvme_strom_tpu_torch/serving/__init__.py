"""Serving over the SSD -> card data path: the JAX package's ``serving/``.

Three legs, each over the port's own machinery:

* :mod:`.hbm_tier` — the HBM tier of the residency hierarchy: extents the
  RAM tier sees touched twice are promoted into uint8 CUDA tensors, a
  read is served from them first, and eviction demotes the bytes back
  into the RAM tier (config ``tier_hbm_bytes``, default 0 = off);
* :mod:`.weights` — a model's cold start: a checkpoint streamed layer by
  layer onto the card, ``weight_stream_depth`` layers in flight, each
  leaf crc32c-checked before its layer is handed out
  (:func:`stream_weights`), and its sharded form over host threads with a
  digest handshake through the ring all-gather
  (:func:`stream_weights_sharded`);
* :mod:`.kvcache` — an SSD-backed KV block pool: fixed-size blocks with
  per-sequence block tables, the working set pinned in the HBM tier, LRU
  demotion HBM -> pinned RAM -> SSD over the write ladder, prefetch on a
  sequence's resume, and migration of whole chains to a peer pool
  (:class:`KvBlockPool`).
"""

from .hbm_tier import HbmLease, HbmResidencyTier, hbm_tier
from .kvcache import KvBlockPool
from .weights import StreamedModel, stream_weights, stream_weights_sharded

__all__ = ["HbmLease", "HbmResidencyTier", "hbm_tier", "KvBlockPool",
           "StreamedModel", "stream_weights", "stream_weights_sharded"]
