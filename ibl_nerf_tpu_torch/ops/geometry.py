"""Geometric helpers: tangent frames, hemisphere sampling, depth ->
position / screen-space normal, and spherical camera poses.

Counterpart of ibl_nerf_tpu/ops/geometry.py. The low-discrepancy
hemisphere directions of the Monte-Carlo estimator are numpy, computed
as the JAX package computes them (bit for bit); the uniform hemisphere
sampler takes its uniforms from the caller.
"""

from __future__ import annotations

import numpy as np
import torch


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def get_tbn(normal: torch.Tensor):
    """A (binormal, tangent) frame from normals (..., 3). The frame jumps
    where normal x crosses normal z (the branch of the reference)."""
    cond = normal[..., 0] > normal[..., 2]
    zeros = torch.zeros_like(normal[..., 0])
    b0 = torch.where(cond, -normal[..., 1], zeros)
    b1 = torch.where(cond, normal[..., 0], -normal[..., 2])
    b2 = torch.where(cond, zeros, normal[..., 1])
    binormal = _normalize(torch.stack([b0, b1, b2], dim=-1))
    tangent = torch.linalg.cross(binormal, normal, dim=-1)
    return binormal, tangent


def _map_uv_to_direction(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The area-preserving square -> hemisphere map, vectorised over the
    grid: octant, then the polar angle from x and the azimuth from y/x."""
    x = 2 * u - 1
    y = 2 * v - 1

    c1 = y > -x
    c2 = y < x
    c3 = y > 0
    c4 = x > 0
    c5 = y > x

    xx = np.where(
        c1,
        np.where(c2, x, y),
        np.where(c5, -x, -y),
    )
    offset = np.where(
        c1,
        np.where(c2, np.where(c3, 0, 7), np.where(c4, 1, 2)),
        np.where(c5, np.where(c3, 3, 4), np.where(c4, 6, 5)),
    ).astype(np.float64)
    yy = np.where(
        c1,
        np.where(c2, np.where(c3, y, x + y), np.where(c4, y - x, -x)),
        np.where(c5, np.where(c3, -x - y, -y), np.where(c4, x, x - y)),
    )

    degenerate = (~c1) & (~c5) & (~c4) & (y == 0)
    xx_safe = np.where(xx == 0, 1.0, xx)

    theta = np.arccos(np.clip(1 - xx * xx, -1.0, 1.0))
    phi = (np.pi / 4) * (offset + yy / xx_safe)
    d = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
        axis=-1,
    )
    return np.where(degenerate[..., None], np.array([0.0, 1.0, 0.0]), d)


def hemisphere_samples(n: int, offset=(0.5, 0.5)) -> np.ndarray:
    """n*n low-discrepancy hemisphere directions about +z, (n*n, 3) f32."""
    idx = np.arange(n * n)
    u = ((idx // n).astype(np.float64) + offset[0]) / n
    v = ((idx % n).astype(np.float64) + offset[1]) / n
    return _map_uv_to_direction(u, v).astype(np.float32)


def uniform_hemisphere_samples(u: torch.Tensor) -> torch.Tensor:
    """Uniform hemisphere directions about +z from (n, 2) uniforms in
    [0, 1) (JAX draws them with jax.random.uniform(key, (n, 2)))."""
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1 - z * z, 0.0, 1.0))
    phi = 2 * np.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=1)


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
