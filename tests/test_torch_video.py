"""`utils/video.py`'s `.mp4` files and AVIs of more than one RIFF list,
read back by OpenCV's FFmpeg reader frame for frame, and their
structure: the ISO-BMFF boxes and, for the OpenDML layout, each RIFF's
size, the frame counts of `avih`, `strh` and `dmlh`, `idx1`, and the
`indx` super-index walked to every `ix00` entry and frame. AVI_LIMIT is
lowered so that a few small frames span several RIFFs.
"""

import os
import struct

import cv2
import numpy as np
import pytest

from ibl_nerf_tpu_torch.utils import video
from ibl_nerf_tpu_torch.utils.png import write_png


def _read(path):
    cap = cv2.VideoCapture(path)
    fps, frames = cap.get(cv2.CAP_PROP_FPS), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return fps, np.stack(frames) if frames else np.zeros((0,), np.uint8)


def _frames(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _boxes(data, start=0, end=None):
    """{kind: (offset, size)} of the boxes in data[start:end], descending
    into the container boxes."""
    out, pos, end = {}, start, len(data) if end is None else end
    while pos < end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
        out[kind] = (pos, size)
        if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
            out.update(_boxes(data, pos + head, pos + size))
        pos += size
    return out


@pytest.mark.parametrize("n,h,w", [(5, 7, 13), (3, 16, 16), (4, 24, 30)])
def test_mp4_frames_read_back_exactly(tmp_path, n, h, w):
    frames = _frames(n, h, w)
    path = video.write_mp4(str(tmp_path / "v.mp4"), frames)
    fps, got = _read(path)
    assert fps == 30.0 and got.shape == frames.shape
    np.testing.assert_array_equal(got, frames)
    data = open(path, "rb").read()
    boxes = _boxes(data)
    assert data[4:12] == b"ftypqt  "
    assert boxes[b"moov"][0] < boxes[b"mdat"][0]
    assert boxes[b"mdat"][0] + boxes[b"mdat"][1] == len(data)
    at, _ = boxes[b"co64"]
    count = struct.unpack(">I", data[at + 12:at + 16])[0]
    offsets = np.frombuffer(data, ">u8", count, at + 16)
    assert count == n
    for i, off in enumerate(offsets):  # each sample is the frame's packed RGB rows
        assert data[off:off + 3 * h * w] == frames[i].tobytes()
    at, _ = _boxes(data)[b"stsd"]
    assert data[at + 20:at + 24] == b"raw " and struct.unpack(
        ">H", data[at + 24 + 74:at + 24 + 76])[0] == 24


def test_stack_and_png_sequence_to_mp4(tmp_path):
    stack = np.random.default_rng(1).uniform(-0.1, 1.1, (4, 9, 11, 3)).astype(np.float32)
    _, got = _read(video.export_stack_as_video(stack, str(tmp_path / "s.mp4")))
    np.testing.assert_array_equal(got, (np.clip(stack, 0, 1) * 255).astype(np.uint8))
    frames = _frames(3, 9, 11, seed=2)
    for i, f in enumerate(frames):
        write_png(str(tmp_path / f"rgb_{i:03d}.png"), f)
    _, got = _read(video.export_as_video(str(tmp_path), "rgb_*.png", str(tmp_path / "p.mov")))
    np.testing.assert_array_equal(got, frames)


def _riffs(data):
    """[(offset, form, size)] of the top-level RIFF lists."""
    out, pos = [], 0
    while pos < len(data):
        assert data[pos:pos + 4] == b"RIFF"
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((pos, data[pos + 8:pos + 12], size))
        pos += 8 + size
    assert pos == len(data)
    return out


def _odml_frames(data, h, w):
    """The frames the indx super-index reaches through each ix00."""
    at = data.index(b"indx")
    longs, _, kind, entries, chunk = struct.unpack("<HBBI4s", data[at + 8:at + 20])
    assert (longs, kind, chunk) == (4, 0, b"00db")
    row, frames = (3 * w + 3) // 4 * 4, []
    for e in range(entries):
        off, _, duration = struct.unpack("<QII", data[at + 32 + 16 * e:at + 48 + 16 * e])
        assert data[off:off + 4] == b"ix00"
        longs, _, kind, count, chunk, base = struct.unpack("<HBBI4sQ", data[off + 8:off + 28])
        assert (longs, kind, chunk, count) == (2, 1, b"00db", duration)
        for k in range(count):
            rel, size = struct.unpack("<II", data[off + 32 + 8 * k:off + 40 + 8 * k])
            assert data[base + rel - 8:base + rel - 4] == b"00db" and size == row * h
            img = np.frombuffer(data, np.uint8, size, base + rel).reshape(h, row)
            frames.append(img[:, :3 * w].reshape(h, w, 3)[..., ::-1])
    return np.stack(frames)


@pytest.mark.parametrize("limit,n,h,w", [(6000, 9, 24, 32), (20000, 9, 24, 32),
                                         (5000, 12, 7, 13), (1 << 20, 5, 7, 13)])
def test_avi_riffs_read_back_exactly(tmp_path, monkeypatch, limit, n, h, w):
    monkeypatch.setattr(video, "AVI_LIMIT", limit)
    frames = _frames(n, h, w, seed=limit)
    path = video.write_avi(str(tmp_path / "v.avi"), frames)
    fps, got = _read(path)
    assert fps == 30.0 and got.shape == frames.shape
    np.testing.assert_array_equal(got, frames)

    data = open(path, "rb").read()
    riffs = _riffs(data)
    assert [form for _, form, _ in riffs] == [b"AVI "] + [b"AVIX"] * (len(riffs) - 1)
    assert all(size <= limit for *_, size in riffs)
    first = struct.unpack("<I", data[data.index(b"avih") + 24:data.index(b"avih") + 28])[0]
    strh = data.index(b"strh")
    assert struct.unpack("<I", data[strh + 40:strh + 44])[0] == n
    idx1 = data.index(b"idx1", riffs[0][0], riffs[1][0] if len(riffs) > 1 else len(data))
    assert struct.unpack("<I", data[idx1 + 4:idx1 + 8])[0] == 16 * first
    if len(riffs) == 1:
        assert first == n and b"indx" not in data and b"odml" not in data
        return
    assert 0 < first < n
    dmlh = data.index(b"dmlh")
    assert struct.unpack("<I", data[dmlh + 8:dmlh + 12])[0] == n
    np.testing.assert_array_equal(_odml_frames(data, h, w), frames)


def test_avi_fills_each_riff(tmp_path, monkeypatch):
    """At the limit one RIFF holds every frame; one byte less needs two."""
    frames = _frames(6, 8, 8)
    single = video.write_avi(str(tmp_path / "a.avi"), frames)
    size = os.path.getsize(single) - 8
    monkeypatch.setattr(video, "AVI_LIMIT", size)
    assert len(_riffs(open(video.write_avi(str(tmp_path / "b.avi"), frames), "rb").read())) == 1
    monkeypatch.setattr(video, "AVI_LIMIT", size - 1)
    data = open(video.write_avi(str(tmp_path / "c.avi"), frames), "rb").read()
    assert len(_riffs(data)) == 2
    np.testing.assert_array_equal(_read(str(tmp_path / "c.avi"))[1], frames)
