"""On-read image resizing (weed/images analog).

``resized`` reproduces weed/images/resizing.go Resized semantics: when
width/height are given and the blob is a decodable image, scale it —
mode "" (fit within box, keep ratio), "fill" (cover + center crop), or
"fit" (exact box, may distort); otherwise return the original bytes
unchanged. Wired into the volume server's GET path via
``?width=&height=&mode=`` query parameters.

The port of ``seaweedfs_tpu/images/__init__.py``, whole.
"""

from .resize import resized

__all__ = ["resized"]
