"""Pinhole-camera ray generation.

Counterpart of ibl_nerf_tpu/ops/rays.py: the camera looks down -z, +x
right, -y down in pixel space; rays are rotated into world space by the
camera-to-world rotation.
"""

from __future__ import annotations

import torch


def _dirs_from_pixels(i: torch.Tensor, j: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-space directions for pixel coords (i=u=col, j=v=row)."""
    return torch.stack(
        [(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -torch.ones_like(i)],
        dim=-1,
    )


def _rotate_to_world(dirs: torch.Tensor, c2w: torch.Tensor):
    # Row-vector contraction sum(dirs[..., None, :] * c2w[:3, :3], -1).
    rays_d = torch.sum(dirs[..., None, :] * c2w[..., :3, :3], dim=-1)
    rays_o = torch.broadcast_to(c2w[..., :3, -1], rays_d.shape)
    return rays_o, rays_d


def get_rays_full_image(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """Rays for every pixel of an HxW image. Returns (rays_o, rays_d), each (H, W, 3)."""
    i, j = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        indexing="xy",
    )
    return _rotate_to_world(_dirs_from_pixels(i, j, K), c2w)


def get_rays_for_pixels(uv: torch.Tensor, K: torch.Tensor, c2w: torch.Tensor):
    """Rays for a flat list of pixel coords ``uv[..., 2]`` (u=col, v=row)."""
    return _rotate_to_world(_dirs_from_pixels(uv[..., 0], uv[..., 1], K), c2w)
