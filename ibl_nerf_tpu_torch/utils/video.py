"""Image stack or PNG sequence -> video.

Counterpart of ibl_nerf_tpu/utils/video.py, which writes XVID through
cv2's VideoWriter; the port may not import cv2, so only the codec
differs: each frame is stored uncompressed as a 24-bit BGR DIB (rows
padded to 4 bytes) in a RIFF AVI 1.0 file with an `idx1` index at 30
fps, written with struct and numpy, so a reader decodes the exact
frames. The rows are stored top-down (a negative DIB height): OpenCV
5.0's FFmpeg-backed reader corrupts its heap on bottom-up 24-bit
frames, which FFmpeg hands it with a negative stride. The frames are
the JAX package's: a float stack becomes
`(np.clip(x, 0, 1) * 255).astype(uint8)`, which truncates.

An uncompressed AVI 1.0 file must stay within 1 GiB, and `.mp4` needs a
codec: both raise, naming the reason.
"""

from __future__ import annotations

import glob
import os
import struct

import numpy as np

from ibl_nerf_tpu_torch.data import native_loader

AVI_LIMIT = 1 << 30  # AVI 1.0 readers stop at a 1 GiB RIFF
_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(data)) + data + (b"\0" if len(data) % 2 else b"")


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body


def write_avi(path: str, frames: np.ndarray, fps: int = 30) -> str:
    """Write (N, H, W, 3) uint8 RGB frames to the AVI file `path`."""
    if path.lower().endswith(".mp4"):
        raise ValueError(f"{path}: the port writes uncompressed AVI only; .mp4 needs a "
                         "codec (use an .avi path)")
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"write_avi takes (N, H, W, 3) uint8, got {frames.shape} "
                         f"{frames.dtype}")
    n, h, w, _ = frames.shape
    row = (3 * w + 3) // 4 * 4
    size = row * h
    avih = struct.pack("<14I", 1000000 // fps, size * fps, 0, _AVIF_HASINDEX, n, 0, 1,
                       size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"DIB ", 0, 0, 0, 0, 1, fps, 0, n,
                       size, -1, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    # "AVI ", hdrl, the movi list's header and chunks, idx1
    riff = 4 + len(hdrl) + 12 + n * (8 + size) + 8 + 16 * n
    if riff > AVI_LIMIT:
        raise ValueError(f"{n} frames of {w}x{h} need a {riff}-byte RIFF: more than the "
                         "1 GiB an uncompressed AVI 1.0 file may hold")

    # top-down BGR rows, each padded to a multiple of 4 bytes
    dib = np.zeros((n, h, row), np.uint8)
    dib[:, :, :3 * w] = frames[..., ::-1].reshape(n, h, 3 * w)
    movi = b"".join(_chunk(b"00db", dib[i].tobytes()) for i in range(n))
    # idx1 offsets count from the 'movi' fourcc
    idx1 = b"".join(struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME, 4 + i * (8 + size), size)
                    for i in range(n))
    body = b"AVI " + hdrl + _list(b"movi", movi) + _chunk(b"idx1", idx1)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def export_as_video(image_dir: str, pattern: str, out_path: str, fps: int = 30) -> str:
    """Encode the PNGs `{image_dir}/{pattern}` (glob, sorted) into an AVI
    at `out_path`; the frames decode through the native PNG decoder."""
    files = sorted(glob.glob(os.path.join(image_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no frames match {pattern} in {image_dir}")
    h, w, _ = native_loader.probe_png(files[0])
    frames = native_loader.batch_load_png_rgb(files, h, w)
    return write_avi(out_path, np.rint(frames * 255.0).astype(np.uint8), fps)


def export_stack_as_video(stack, out_path: str, fps: int = 30) -> str:
    """(N, H, W, 3) float [0, 1] RGB stack -> AVI at `out_path`."""
    frames = (np.clip(np.asarray(stack), 0, 1) * 255).astype(np.uint8)
    return write_avi(out_path, frames, fps)
