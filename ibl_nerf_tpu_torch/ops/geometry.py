"""Depth -> position / screen-space normal.

Counterpart of `depth_to_position` and `depth_to_normal_image_space` in
ibl_nerf_tpu/ops/geometry.py. The tangent frames and hemisphere
samplers of the Monte-Carlo estimator are not ported yet.
"""

from __future__ import annotations

import torch


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def depth_to_position(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor,
                      depth: torch.Tensor) -> torch.Tensor:
    """World positions from a depth map along *normalized* pixel rays."""
    i, j = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=depth.device),
        torch.arange(H, dtype=torch.float32, device=depth.device),
        indexing="xy",
    )
    dirs = torch.stack(
        [(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -torch.ones_like(i)],
        dim=-1)
    dirs = _normalize(dirs)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    return c2w[:3, -1] + rays_d * depth[..., None]


def depth_to_normal_image_space(depth: torch.Tensor, c2w: torch.Tensor,
                                K: torch.Tensor) -> torch.Tensor:
    """Screen-space normals from a depth image via edge-padded central
    differences + cross product."""
    H, W = depth.shape
    pos = depth_to_position(H, W, K, c2w, depth)
    rows = torch.clamp(torch.arange(-1, H + 1, device=depth.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-1, W + 1, device=depth.device), 0, W - 1)
    padded = pos[rows][:, cols]                          # (H+2, W+2, 3)
    left = padded[1:-1, :-2, :]
    right = padded[1:-1, 2:, :]
    up = padded[:-2, 1:-1, :]
    bottom = padded[2:, 1:-1, :]
    va = _normalize(right - left)
    vb = _normalize(bottom - up)
    return _normalize(torch.linalg.cross(vb, va, dim=-1))
