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


# Patch sampling uses the same math over an extra neighbour axis.
get_rays_for_patches = get_rays_for_pixels

# (du, dv) of the 8-neighbourhood, in the reference's order
_NEIGHBOR_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def neighbor_coords(uv: torch.Tensor) -> torch.Tensor:
    """8-neighbourhood of integer pixel coords: (N, 2) -> (N, 8, 2)."""
    offsets = torch.tensor(_NEIGHBOR_OFFSETS, dtype=uv.dtype, device=uv.device)
    return uv[:, None, :] + offsets


def ndc_rays(H: int, W: int, focal: float, near: float,
             rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Normalized-device-coordinate reparameterization of forward-facing
    rays (no live config uses it)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
