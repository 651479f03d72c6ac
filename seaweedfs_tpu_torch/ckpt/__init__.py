"""Checkpoint & dataloader workload plane.

The end-to-end ML consumer of the store: save a tree of torch tensors
sharded over a (dp, sp) mesh through the S3 gateway as one object per
(param, shard) plus a committed manifest, restore it onto a mesh with
each process range-reading only its own blocks' bytes, and stream data
objects in seeded shuffled scans with bounded prefetch.

The port of ``seaweedfs_tpu/ckpt``: the manifest format
(``seaweed-ckpt/1``) and the object layout are the JAX package's, so a
checkpoint saved by either package restores in the other.
"""

from .loader import ObjectLoader
from .manifest import (FORMAT, Manifest, ManifestError, ParamSpec,
                       ShardEntry, spec_from_json, spec_to_json)
from .s3client import GatewayClient, GatewayError
from .sharding import (Block, NamedSharding, PartitionSpec, ShardedTensor,
                       device_put)
from .store import CheckpointError, CheckpointStore, CorruptShardError

__all__ = ["FORMAT", "Block", "CheckpointError", "CheckpointStore",
           "CorruptShardError", "GatewayClient", "GatewayError",
           "Manifest", "ManifestError", "NamedSharding", "ObjectLoader",
           "ParamSpec", "PartitionSpec", "ShardEntry", "ShardedTensor",
           "device_put", "spec_from_json", "spec_to_json"]
