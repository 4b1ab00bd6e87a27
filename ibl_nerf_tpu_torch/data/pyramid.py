"""Prefiltered ground-truth pyramid.

Counterpart of ibl_nerf_tpu/data/pyramid.py: level k is the image
shrunk by 4**k (sizes taken from the original resolution) with
INTER_AREA, then enlarged back to the working resolution with
INTER_LINEAR -- the area low-pass that supervises the K coarse radiance
heads. The resamplers are OpenCV's, reproduced in `data/resize.py`.
"""

from __future__ import annotations

import numpy as np

from ibl_nerf_tpu_torch.data.resize import area_weights, linear_weights

COARSE_RESIZE_SCALE = 4


def level_size(h: int, w: int, level: int, image_scale: float = 1.0) -> tuple[int, int]:
    """(height, width) of pyramid level `level` (1-based) before the
    enlargement back."""
    sh, sw = int(h / image_scale), int(w / image_scale)
    for _ in range(level):
        sh //= COARSE_RESIZE_SCALE
        sw //= COARSE_RESIZE_SCALE
    return max(sh, 1), max(sw, 1)


def build_prefiltered_pyramid(images: np.ndarray, levels: int,
                              image_scale: float = 1.0) -> np.ndarray:
    """images: (N, H, W, 3) float; returns (levels, N, H, W, 3)."""
    n, h, w, c = images.shape
    out = np.empty((levels, n, h, w, c), dtype=images.dtype)
    # (H, W, N*C): both passes are products over the two leading axes
    x = np.ascontiguousarray(images.transpose(1, 2, 0, 3).reshape(h, w, n * c), np.float64)
    for level in range(1, levels + 1):
        sh, sw = level_size(h, w, level, image_scale)
        small = np.tensordot(area_weights(h, sh), x, axes=(1, 0))
        small = np.tensordot(small, area_weights(w, sw), axes=(1, 1))     # (sh, N*C, sw)
        # OpenCV rounds the small image to float32 between the two resizes
        small = small.astype(np.float32).astype(np.float64)
        up = np.tensordot(linear_weights(sh, h), small, axes=(1, 0))      # (H, N*C, sw)
        up = np.tensordot(up, linear_weights(sw, w), axes=(2, 1))         # (H, N*C, W)
        out[level - 1] = up.reshape(h, n, c, w).transpose(1, 0, 3, 2)
    return out
