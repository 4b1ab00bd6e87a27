"""Image stack or PNG sequence -> video.

Counterpart of ibl_nerf_tpu/utils/video.py, which writes XVID (.avi) or
mp4v (other names) through cv2's VideoWriter. The port may not import
cv2, so only the codec differs: every frame is stored uncompressed, so
a reader decodes the exact frames, written with struct and numpy. The
frames are the JAX package's: a float stack becomes
`(np.clip(x, 0, 1) * 255).astype(uint8)`, which truncates.

- `.avi`: 24-bit BGR DIB frames (rows padded to 4 bytes) at `fps`. The
  rows are stored top-down (a negative DIB height): OpenCV 5.0's
  FFmpeg-backed reader corrupts its heap on bottom-up 24-bit frames,
  which FFmpeg hands it with a negative stride. A file whose RIFF list
  fits in `AVI_LIMIT` bytes is plain AVI 1.0 with an `idx1` index. A
  longer one takes the OpenDML (AVI 2.0) layout: the first `RIFF AVI `
  keeps its `idx1` for AVI 1.0 readers, which see only its frames (the
  count in `avih`); further `RIFF AVIX` lists hold the rest; the
  stream's `indx` super-index points at one `ix00` standard index at
  the end of each `movi` list, and `dmlh` counts every frame.
- `.mp4` / `.mov`: an ISO-BMFF file -- `ftyp`, `moov` with `co64`
  chunk offsets, then a 64-bit `mdat` -- whose one video track holds
  QuickTime `raw ` samples of depth 24: packed RGB rows, top-down, one
  sample per chunk. FFmpeg's mov demuxer maps that entry to rawvideo.
"""

from __future__ import annotations

import glob
import os
import struct

import numpy as np

from ibl_nerf_tpu_torch.data import native_loader

AVI_LIMIT = 1 << 30  # bytes in one RIFF list: AVI 1.0 readers stop at 1 GiB
_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_MP4_SUFFIXES = (".mp4", ".mov", ".m4v")
# the file offset of the `indx` chunk's data: the RIFF and hdrl headers,
# avih, the strl list's header, strh and strf, the indx chunk's header
_INDX_DATA_AT = 12 + 12 + (8 + 56) + 12 + (8 + 56) + (8 + 40) + 8


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(data)) + data + (b"\0" if len(data) % 2 else b"")


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body


def _check_frames(frames) -> np.ndarray:
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"video frames must be (N, H, W, 3) uint8, got {frames.shape} "
                         f"{frames.dtype}")
    return frames


def _avi_header(n: int, first: int, w: int, h: int, size: int, fps: int,
                riffs: int) -> bytes:
    """The `hdrl` list; OpenDML's `indx` (with `riffs` entries, zero
    until filled) and `odml` lists when there is more than one RIFF."""
    avih = struct.pack("<14I", 1000000 // fps, size * fps, 0, _AVIF_HASINDEX, first, 0, 1,
                       size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"DIB ", 0, 0, 0, 0, 1, fps, 0, n,
                       size, -1, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    strl = _chunk(b"strh", strh) + _chunk(b"strf", strf)
    odml = b""
    if riffs > 1:
        strl += _chunk(b"indx", bytes(24 + 16 * riffs))
        odml = _list(b"odml", _chunk(b"dmlh", struct.pack("<I", n) + bytes(244)))
    return _list(b"hdrl", _chunk(b"avih", avih) + _list(b"strl", strl) + odml)


def _avi_plan(n: int, w: int, h: int, size: int, fps: int) -> tuple[bytes, list[int]]:
    """(hdrl, frames in each RIFF): one RIFF when it fits in AVI_LIMIT,
    else as few as hold the frames, each filled up to AVI_LIMIT."""
    per = 8 + size
    riffs = 1
    while True:
        # the first RIFF: "AVI ", hdrl, movi's header, frames, its ix00, idx1
        hdrl = _avi_header(n, n, w, h, size, fps, riffs)
        ix = 0 if riffs == 1 else 32
        fixed0, fixedx = 4 + len(hdrl) + 12 + ix + 8, 4 + 12 + ix
        per0, perx = per + 16 + (8 if riffs > 1 else 0), per + 8
        first = min(n, (AVI_LIMIT - fixed0) // per0)
        if first < 1 or (riffs > 1 and (AVI_LIMIT - fixedx) // perx < 1):
            raise ValueError(f"one {w}x{h} frame does not fit in a {AVI_LIMIT}-byte RIFF")
        rest = n - first
        if riffs == 1 and rest == 0:
            return hdrl, [n]
        cap = (AVI_LIMIT - fixedx) // perx
        if riffs > 1 and rest <= (riffs - 1) * cap:
            counts = [first] + [min(cap, rest - j * cap) for j in range(riffs - 1)]
            return _avi_header(n, first, w, h, size, fps, riffs), counts
        riffs = max(riffs + 1, 1 + -(-rest // cap))


def write_avi(path: str, frames: np.ndarray, fps: int = 30) -> str:
    """Write (N, H, W, 3) uint8 RGB frames to the AVI file `path`, one
    RIFF list per AVI_LIMIT bytes."""
    frames = _check_frames(frames)
    n, h, w, _ = frames.shape
    row = (3 * w + 3) // 4 * 4
    size = row * h
    hdrl, counts = _avi_plan(n, w, h, size, fps)
    odml = len(counts) > 1
    dib = np.zeros((h, row), np.uint8)
    chunk_header = b"00db" + struct.pack("<I", size)
    supers = []
    with open(path, "wb") as f:
        start = 0
        for j, count in enumerate(counts):
            riff_at = f.tell()
            movi = 4 + count * (8 + size) + (32 + 8 * count if odml else 0)
            body = 12 + movi + (8 + 16 * count if j == 0 else 0)
            f.write(b"RIFF" + struct.pack("<I", (len(hdrl) if j == 0 else 0) + body)
                    + (b"AVI " + hdrl if j == 0 else b"AVIX"))
            f.write(b"LIST" + struct.pack("<I", movi) + b"movi")
            movi_at = f.tell() - 4
            for i in range(start, start + count):
                # top-down BGR rows, each padded to a multiple of 4 bytes
                dib[:, :3 * w] = frames[i, :, :, ::-1].reshape(h, 3 * w)
                f.write(chunk_header)
                f.write(dib.tobytes())
            if odml:
                # ix00: each frame's data offset from the RIFF's start
                ix_at = f.tell()
                first_data = movi_at + 4 + 8 - riff_at
                entries = np.empty((count, 2), "<u4")
                entries[:, 0] = first_data + np.arange(count, dtype=np.int64) * (8 + size)
                entries[:, 1] = size
                f.write(b"ix00" + struct.pack("<IHBBI4sQI", 24 + 8 * count, 2, 0, 1, count,
                                              b"00db", riff_at, 0) + entries.tobytes())
                supers.append((ix_at, 32 + 8 * count, count))
            if j == 0:
                # idx1 offsets count from the 'movi' fourcc
                idx1 = np.empty((count, 4), "<u4")
                idx1[:, 0] = struct.unpack("<I", b"00db")[0]
                idx1[:, 1] = _AVIIF_KEYFRAME
                idx1[:, 2] = 4 + np.arange(count, dtype=np.int64) * (8 + size)
                idx1[:, 3] = size
                f.write(b"idx1" + struct.pack("<I", 16 * count) + idx1.tobytes())
            start += count
        if odml:
            # fill the super-index reserved in the header
            f.seek(_INDX_DATA_AT)
            f.write(struct.pack("<HBBI4s12x", 4, 0, 0, len(supers), b"00db"))
            for at, nbytes, count in supers:
                f.write(struct.pack("<QII", at, nbytes, count))
    return path


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def write_mp4(path: str, frames: np.ndarray, fps: int = 30) -> str:
    """Write (N, H, W, 3) uint8 RGB frames to `path` as an ISO-BMFF file
    of raw 24-bit RGB samples (see the module docstring)."""
    frames = _check_frames(frames)
    n, h, w, _ = frames.shape
    size = 3 * w * h
    entry = _box(b"raw ", bytes(6), struct.pack(">H", 1),
                 struct.pack(">HHIIIHHIIIH", 0, 0, 0, 0, 0, w, h, 0x480000, 0x480000, 0, 1),
                 bytes(32), struct.pack(">Hh", 24, -1))

    def moov(offsets: np.ndarray) -> bytes:
        stbl = _box(b"stbl",
                    _box(b"stsd", struct.pack(">II", 0, 1), entry),
                    _box(b"stts", struct.pack(">IIII", 0, 1, n, 1)),
                    _box(b"stsc", struct.pack(">IIIII", 0, 1, 1, 1, 1)),
                    _box(b"stsz", struct.pack(">III", 0, size, n)),
                    _box(b"co64", struct.pack(">II", 0, n), offsets.astype(">u8").tobytes()))
        minf = _box(b"minf", _box(b"vmhd", struct.pack(">IH3H", 1, 0, 0, 0, 0)),
                    _box(b"dinf", _box(b"dref", struct.pack(">II", 0, 1),
                                       _box(b"url ", struct.pack(">I", 1)))), stbl)
        mdia = _box(b"mdia", _box(b"mdhd", struct.pack(">IIIIIHH", 0, 0, 0, fps, n, 0x55C4, 0)),
                    _box(b"hdlr", struct.pack(">I4s4s12x", 0, b"mhlr", b"vide"),
                         b"\x0cVideoHandler"), minf)
        tkhd = _box(b"tkhd", struct.pack(">IIIII", 3, 0, 0, 1, 0), struct.pack(">I", n),
                    bytes(8), struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                    struct.pack(">II", w << 16, h << 16))
        mvhd = _box(b"mvhd", struct.pack(">IIIII", 0, 0, 0, fps, n),
                    struct.pack(">IH10x", 0x10000, 0x100), _MATRIX, bytes(24),
                    struct.pack(">I", 2))
        return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))

    ftyp = _box(b"ftyp", b"qt  ", struct.pack(">I", 0x200), b"qt  ")
    data_at = len(ftyp) + len(moov(np.zeros(n, np.int64))) + 16
    offsets = data_at + np.arange(n, dtype=np.int64) * size
    with open(path, "wb") as f:
        f.write(ftyp + moov(offsets))
        f.write(struct.pack(">I4sQ", 1, b"mdat", 16 + n * size))
        for i in range(n):
            f.write(np.ascontiguousarray(frames[i]).tobytes())
    return path


def write_video(path: str, frames: np.ndarray, fps: int = 30) -> str:
    """`write_avi` for an `.avi` path, `write_mp4` for `.mp4`, `.mov` or
    `.m4v`; other names raise."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".avi":
        return write_avi(path, frames, fps)
    if ext in _MP4_SUFFIXES:
        return write_mp4(path, frames, fps)
    raise ValueError(f"{path}: the port writes .avi, .mp4, .mov or .m4v video")


def export_as_video(image_dir: str, pattern: str, out_path: str, fps: int = 30) -> str:
    """Encode the PNGs `{image_dir}/{pattern}` (glob, sorted) into a video
    at `out_path`; the frames decode through the native PNG decoder."""
    files = sorted(glob.glob(os.path.join(image_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no frames match {pattern} in {image_dir}")
    h, w, _ = native_loader.probe_png(files[0])
    frames = native_loader.batch_load_png_rgb(files, h, w)
    return write_video(out_path, np.rint(frames * 255.0).astype(np.uint8), fps)


def export_stack_as_video(stack, out_path: str, fps: int = 30) -> str:
    """(N, H, W, 3) float [0, 1] RGB stack -> video at `out_path`."""
    frames = (np.clip(np.asarray(stack), 0, 1) * 255).astype(np.uint8)
    return write_video(out_path, frames, fps)
