"""Texture / LUT sampling and mip interpolation.

Counterpart of ibl_nerf_tpu/ops/texture.py: bilinear sampling with
align_corners=True and border clamping (the BRDF-LUT fetch), and the
continuous lookup along the prefiltered-radiance mip stack.
"""

from __future__ import annotations

import torch


def grid_sample_2d(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear texture sampling with align_corners=True semantics.

    tex: (H, W, C) texture.
    uv:  (..., 2) coords in [-1, 1]; uv[..., 0] indexes width (x),
         uv[..., 1] indexes height (y).
    Returns (..., C). Out-of-range coords are clamped to the border.
    """
    H, W, C = tex.shape
    x = (uv[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (uv[..., 1] + 1.0) * 0.5 * (H - 1)

    x0 = torch.clamp(torch.floor(x), 0, W - 1)
    y0 = torch.clamp(torch.floor(y), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx = (torch.clamp(x, 0, W - 1) - x0)[..., None]
    wy = (torch.clamp(y, 0, H - 1) - y0)[..., None]

    flat = tex.reshape(H * W, C)

    def fetch(yi, xi):
        idx = (yi.long() * W + xi.long()).reshape(-1)
        return flat[idx].reshape(*yi.shape, C)

    top = fetch(y0, x0) * (1 - wx) + fetch(y0, x1) * wx
    bot = fetch(y1, x0) * (1 - wx) + fetch(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def mip_interp(levels: torch.Tensor, level_value: torch.Tensor) -> torch.Tensor:
    """Continuous lookup along a stacked mip axis.

    levels: (B, L, C) per-ray stack [finest..coarsest].
    level_value: (B,) continuous in [0, 1]; scaled to [0, L-1], the
    floor and floor+1 levels lerped (indices clamped), the floor taken
    by truncation as int() does. Returns (B, C).
    """
    L, C = levels.shape[-2], levels.shape[-1]
    lv = level_value * (L - 1)
    i1 = torch.clamp(lv.to(torch.int64), 0, L - 1)
    i2 = torch.clamp(i1 + 1, 0, L - 1)
    rem = (lv - i1.to(lv.dtype))[..., None]

    def take(i):
        idx = i[..., None, None].expand(*i.shape, 1, C)
        return torch.gather(levels, -2, idx)[..., 0, :]

    return (1.0 - rem) * take(i1) + rem * take(i2)
