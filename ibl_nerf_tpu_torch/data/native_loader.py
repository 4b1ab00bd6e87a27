"""ctypes bindings for the repo's native PNG decoder (native/ibl_data.cc).

Counterpart of ibl_nerf_tpu/data/native_loader.py: a threaded batch
decode of 8-bit PNGs straight into a float32 (N, H, W, 3) array in
[0, 1], RGB order. The library is compiled with g++ into the
git-ignored `build/native/` at first use (`kernels/build.build_native`).
There is no fallback decoder: a file that fails to decode raises,
naming its path.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ibl_nerf_tpu_torch.kernels.build import build_native

_lib = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_native()))
        lib.ibl_probe_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ibl_probe_png.restype = ctypes.c_int
        lib.ibl_batch_load_png_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.ibl_batch_load_png_rgb.restype = ctypes.c_int
        _lib = lib
    return _lib


def native_available() -> bool:
    """True once the decoder has built and loaded; False, without
    raising, when g++, zlib's header or the library is missing."""
    try:
        _get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def probe_png(path: str) -> tuple[int, int, int]:
    """(height, width, channels) of a PNG file."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _get_lib().ibl_probe_png(path.encode(), ctypes.byref(h), ctypes.byref(w),
                                  ctypes.byref(c))
    if rc != 0:
        raise OSError(f"cannot decode PNG {path} (native decoder code {rc})")
    return h.value, w.value, c.value


def batch_load_png_rgb(paths: list[str], out_h: int, out_w: int,
                       n_threads: int = 0) -> np.ndarray:
    """Decode `paths` in parallel into (N, out_h, out_w, 3) float32 in
    [0, 1]; gray images are repeated over the three channels. At the
    files' own size this is each byte / 255 (cv2.imread's values, RGB
    order). Raises naming every file that failed."""
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), dtype=np.float32)
    status = np.zeros((n,), dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = _get_lib().ibl_batch_load_png_rgb(
        arr, n, out_h, out_w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    if failures:
        bad = [f"{p} (code {int(s)})" for p, s in zip(paths, status) if s != 0]
        raise OSError(f"cannot decode {failures} PNG file(s): {', '.join(bad)}")
    return out
