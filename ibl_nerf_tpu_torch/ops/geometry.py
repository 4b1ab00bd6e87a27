"""Depth -> position / screen-space normal, and spherical camera poses.

Counterpart of `depth_to_position`, `depth_to_normal_image_space` and
`pose_spherical` in ibl_nerf_tpu/ops/geometry.py. The tangent frames
and hemisphere samplers of the Monte-Carlo estimator are not ported
yet.
"""

from __future__ import annotations

import numpy as np
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


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """(4, 4) float32 camera-to-world on a sphere of `radius`: azimuth
    `theta` and elevation `phi` in degrees, looking at the origin."""
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius

    p = phi / 180.0 * np.pi
    rot_p = np.array(
        [[1, 0, 0, 0],
         [0, np.cos(p), -np.sin(p), 0],
         [0, np.sin(p), np.cos(p), 0],
         [0, 0, 0, 1]], dtype=np.float32)

    t = theta / 180.0 * np.pi
    rot_t = np.array(
        [[np.cos(t), 0, -np.sin(t), 0],
         [0, 1, 0, 0],
         [np.sin(t), 0, np.cos(t), 0],
         [0, 0, 0, 1]], dtype=np.float32)

    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float32)
    return flip @ rot_t @ rot_p @ trans
