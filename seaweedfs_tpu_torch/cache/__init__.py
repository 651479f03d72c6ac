"""Tiered hot-read chunk cache (weed/util/chunk_cache analog).

``ChunkCache`` = scan-resistant segmented-LRU memory tier + optional
append-only on-disk needle-layer tier, with TTL and explicit
invalidation. ``global_chunk_cache()`` is the process-wide instance the
filer chunk-read path and the gateways share; servers that want their
own metrics namespace (the volume server's post-decode EC cache)
construct their own. cache/invalidation.py fans vacuum / EC-rebuild
notifications out to every live cache.

The port of ``seaweedfs_tpu/cache/__init__.py``, whole.
"""

from .chunk_cache import (METRICS, ChunkCache, SegmentedLRU, chunk_key,
                          configure_global, fid_volume, from_config,
                          global_chunk_cache)
from .disk_tier import DiskTier
from .readahead import (Prefetcher, ReadaheadWindow, shared_prefetcher)
from . import invalidation, readahead

__all__ = ["METRICS", "ChunkCache", "DiskTier", "Prefetcher",
           "ReadaheadWindow", "SegmentedLRU", "chunk_key",
           "configure_global", "fid_volume", "from_config",
           "global_chunk_cache", "invalidation", "readahead",
           "shared_prefetcher"]
