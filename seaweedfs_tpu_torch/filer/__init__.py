"""Filer (L4): path namespace over the blob store (weed/filer analog).

The port of ``seaweedfs_tpu/filer/__init__.py``, whole.
"""

from .entry import Attr, Entry, FileChunk  # noqa: F401
from .filechunks import read_plan, total_size, visible_intervals  # noqa: F401
from .filer import Filer, FilerError  # noqa: F401
from .stores import MemoryStore, SqliteStore  # noqa: F401
