"""Image scaling for the read path (weed/images/resizing.go).

The port of ``seaweedfs_tpu/images/resize.py``, whole.
"""

from __future__ import annotations

import io
from typing import Tuple

_FORMATS = {"JPEG": "image/jpeg", "PNG": "image/png", "GIF": "image/gif",
            "WEBP": "image/webp", "BMP": "image/bmp"}

#: Upper bound on any produced (or intermediate) image, in pixels —
#: query parameters are unauthenticated input, and an unbounded
#: ``?width=100000&height=100000&mode=fit`` would otherwise make Pillow
#: allocate a multi-GB buffer inside the volume server.
MAX_PIXELS = 16_000_000


def resized(data: bytes, width: int = 0, height: int = 0,
            mode: str = "") -> Tuple[bytes, str]:
    """Return (bytes, mime). Unchanged input when no dimensions are
    requested, the payload is not a decodable image, or it is already
    small enough (the reference only ever downscales)."""
    if width <= 0 and height <= 0:
        return data, ""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover — PIL ships in this env
        return data, ""
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception:  # noqa: BLE001 — not an image: serve as-is
        return data, ""
    fmt = (img.format or "PNG").upper()
    w, h = img.size
    if width < 0 or height < 0:
        return data, _FORMATS.get(fmt, "")
    tw, th = width or w, height or h
    if w <= tw and h <= th and mode != "fit":
        return data, _FORMATS.get(fmt, "")
    # The pixel cap is evaluated on what would actually be ALLOCATED
    # per mode (output, plus fill's cover intermediate) — capping
    # tw*th up front would wrongly reject a small single-axis
    # downscale of a large image (th defaults to the original height).
    if mode == "fit":
        # exact target box (resizing.go's "fit": may change the ratio)
        if tw * th > MAX_PIXELS:
            return data, _FORMATS.get(fmt, "")
        out = img.resize((tw, th))
    elif mode == "fill":
        # cover the box, then center-crop to it
        scale = max(tw / w, th / h)
        iw, ih = max(1, round(w * scale)), max(1, round(h * scale))
        if iw * ih > MAX_PIXELS or tw * th > MAX_PIXELS:
            return data, _FORMATS.get(fmt, "")
        out = img.resize((iw, ih))
        left = (out.width - tw) // 2
        top = (out.height - th) // 2
        out = out.crop((left, top, left + tw, top + th))
    else:
        # default: fit WITHIN the box, preserving the ratio
        scale = min(tw / w, th / h, 1.0)
        ow, oh = max(1, round(w * scale)), max(1, round(h * scale))
        if ow * oh > MAX_PIXELS:
            return data, _FORMATS.get(fmt, "")
        out = img.resize((ow, oh))
    buf = io.BytesIO()
    save_fmt = fmt if fmt in _FORMATS else "PNG"
    if save_fmt == "JPEG" and out.mode not in ("RGB", "L"):
        out = out.convert("RGB")
    out.save(buf, format=save_fmt)
    return buf.getvalue(), _FORMATS.get(save_fmt, "")
