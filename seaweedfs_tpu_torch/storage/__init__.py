"""On-disk formats, the append-only ``Volume`` engine and the ``Store``
registry.

Ports of ``seaweedfs_tpu/storage`` (the port imports nothing of the JAX
package), bit-compatible with them: each package reads what the other
writes.
"""
