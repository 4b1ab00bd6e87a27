"""A PNG encoder in numpy and the standard library (zlib, struct).

The JAX package writes its images with `cv2.imwrite`, which the port
may not import. This writes 8-bit gray or RGB, non-interlaced, every
scanline with filter type 0, zlib at its fastest level: any PNG reader
decodes it to the same pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG bytes of a uint8 image: (H, W) or (H, W, 1) gray, (H, W, 3)
    RGB."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png takes (H, W), (H, W, 1) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 1)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 image (see `encode_png`) to `path`."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
