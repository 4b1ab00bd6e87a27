"""Image resampling with OpenCV's numbers, in numpy.

The JAX package resizes with `cv2.resize`, which the port may not
import. This module reproduces the two resamplers it uses:

- INTER_AREA (downsampling): each output pixel averages the source
  pixels its cell covers, a partly covered pixel weighed by the part
  covered (OpenCV's `computeResizeAreaTab`). At a fractional ratio --
  480 rows to 7 -- this differs from an integer box average, and from
  `adaptive_avg_pool2d` and `F.interpolate(mode="area")`.
- INTER_LINEAR: half-pixel centres, the two taps clamped at the edges,
  float32 coefficients. On uint8 images OpenCV works in fixed point
  (11-bit coefficients; the vertical pass in its vector code's 16-bit
  steps), and an exact halving of both sides switches to the 2x2 area
  average rounded half up. Both are reproduced: shrinking a uint8 image
  gives OpenCV's values exactly; enlarging one may differ by one level
  in under 1% of them.

Both are separable, so a float resize is two small matrix products.
"""

from __future__ import annotations

import math

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_DBL_EPSILON = np.finfo(np.float64).eps


def _scale(src: int, dst: int, inv_scale: float | None) -> float:
    """OpenCV's source pixels per output pixel: from the factor when one
    is given, else from the sizes (as 1 / (dst / src))."""
    return 1.0 / (inv_scale if inv_scale is not None else dst / src)


def _is_integer(scale: float) -> bool:
    return abs(scale - round(scale)) < _DBL_EPSILON


def area_weights(src: int, dst: int, scale: float | None = None) -> np.ndarray:
    """(dst, src) INTER_AREA weights along one axis (each row sums to 1)."""
    scale = _scale(src, dst, None) if scale is None else scale
    if scale < 1.0:
        raise ValueError("area resampling only shrinks")
    out = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            out[dx, sx1 - 1] = (sx1 - fsx1) / cell
        out[dx, sx1:sx2] = 1.0 / cell
        if fsx2 - sx2 > 1e-3:
            out[dx, sx2] = min(min(fsx2 - sx2, 1.0), cell) / cell
    return out


def _linear_taps(src: int, dst: int, scale: float):
    """(sx, fx): the left tap and the float32 weight of the right one,
    per output pixel, clamped at both edges as OpenCV clamps them."""
    dx = np.arange(dst, dtype=np.float64)
    fx = ((dx + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    low, high = sx < 0, sx >= src - 1
    fx[low | high] = 0.0
    sx[low] = 0
    sx[high] = src - 1
    return sx, fx


def linear_weights(src: int, dst: int, scale: float | None = None) -> np.ndarray:
    """(dst, src) INTER_LINEAR weights along one axis."""
    scale = _scale(src, dst, None) if scale is None else scale
    sx, fx = _linear_taps(src, dst, scale)
    out = np.zeros((dst, src), np.float64)
    rows = np.arange(dst)
    out[rows, sx] += (np.float32(1.0) - fx).astype(np.float64)
    right = np.minimum(sx + 1, src - 1)
    out[rows, right] += fx.astype(np.float64)
    return out


def _separable(img: np.ndarray, wy: np.ndarray, wx: np.ndarray) -> np.ndarray:
    """wy @ img @ wx^T over the two leading axes, in float64, as float32."""
    x = np.asarray(img, np.float64)
    x = np.tensordot(wy, x, axes=(1, 0))                      # (dh, W, ...)
    x = np.moveaxis(np.tensordot(wx, x, axes=(1, 1)), 0, 1)   # (dh, dw, ...)
    return x.astype(np.float32)


def _linear_u8(img: np.ndarray, dh: int, dw: int, sy: float, sx_scale: float) -> np.ndarray:
    """OpenCV's fixed-point INTER_LINEAR of a uint8 image."""
    h, w = img.shape[:2]
    xs, fx = _linear_taps(w, dw, sx_scale)
    ys, fy = _linear_taps(h, dh, sy)

    def coefs(f):  # saturate_cast<short>: round half to even
        f = f.astype(np.float32)
        return (np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64),
                np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64))

    ax0, ax1 = coefs(fx)
    by0, by1 = coefs(fy)
    src = img.astype(np.int64)
    xr = np.minimum(xs + 1, w - 1)
    col = (slice(None),) + (None,) * (img.ndim - 2)      # over axis 1
    row = (slice(None),) + (None,) * (img.ndim - 1)      # over axis 0
    rows = src[:, xs] * ax0[col] + src[:, xr] * ax1[col]      # (h, dw, ...)
    yr = np.minimum(ys + 1, h - 1)
    # the vertical pass as OpenCV's vector code takes it: rows cut to 16
    # bits (>> 4), the high half of each 16x16-bit product, then >> 2
    # rounded half up
    out = (((rows[ys] >> 4) * by0[row]) >> 16) + (((rows[yr] >> 4) * by1[row]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def _halve_u8(img: np.ndarray) -> np.ndarray:
    """OpenCV's fast 2x2 area average of a uint8 image, rounded half up."""
    h, w = img.shape[:2]
    x = img[: h // 2 * 2, : w // 2 * 2].astype(np.int32)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    return ((s + 2) >> 2).astype(np.uint8)


def resize(img: np.ndarray, size: tuple[int, int] | None = None,
           fx: float | None = None, fy: float | None = None,
           interpolation: str = "linear") -> np.ndarray:
    """`cv2.resize(img, size, fx=fx, fy=fy, interpolation=...)` for an
    (H, W) or (H, W, C) image; `size` is (width, height) as in OpenCV, or
    None with both factors given. uint8 images stay uint8 under
    "linear"; everything else comes back float32."""
    h, w = img.shape[:2]
    if size is None:
        dw, dh = int(np.rint(w * fx)), int(np.rint(h * fy))
        inv_x, inv_y = fx, fy
    else:
        dw, dh = size
        inv_x = inv_y = None
    scale_x, scale_y = _scale(w, dw, inv_x), _scale(h, dh, inv_y)
    if interpolation == "area":
        return _separable(img, area_weights(h, dh, scale_y), area_weights(w, dw, scale_x))
    if interpolation != "linear":
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if img.dtype == np.uint8:
        if (_is_integer(scale_x) and _is_integer(scale_y)
                and round(scale_x) == 2 and round(scale_y) == 2):
            return _halve_u8(img)
        return _linear_u8(img, dh, dw, scale_y, scale_x)
    return _separable(img, linear_weights(h, dh, scale_y), linear_weights(w, dw, scale_x))
