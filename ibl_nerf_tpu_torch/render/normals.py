"""Finite-difference normal estimators from depth gradients.

Counterpart of the ε variants of ibl_nerf_tpu/render/normals.py
(`normal_from_depth_gradient_epsilon`,
`normal_from_depth_gradient_direction_epsilon`). The autograd and
sigma-gradient variants come with the training slice.

`query_sigma` is a callable pts[..., 3] -> raw sigma[..., 1].
"""

from __future__ import annotations

import torch

from ibl_nerf_tpu_torch.ops.compositing import (
    alpha_from_sigma,
    dists_from_z_vals,
    weights_from_alpha,
)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def _pixel_basis(rays_d: torch.Tensor):
    """right/up basis per ray (unnormalized, as the reference)."""
    up_world = torch.tensor([0.0, 1.0, 0.0], dtype=rays_d.dtype,
                            device=rays_d.device).expand(rays_d.shape)
    right = torch.linalg.cross(rays_d, up_world, dim=-1)
    up = torch.linalg.cross(right, rays_d, dim=-1)
    return right, up


def _depth_from_sigma(sigma_raw, dists, z_vals):
    w = weights_from_alpha(alpha_from_sigma(sigma_raw, dists))
    return torch.sum(w * z_vals, dim=-1)


def _sweep_sigma(query_sigma, new_pts: torch.Tensor, scan: bool) -> torch.Tensor:
    """Evaluate the (4, B, S, 3) ε-offset point set -> sigma (4, B, S).

    scan=False: one batched (4B, S, 3) density query, ray axis major
    ((B, 4, ...) -> (4B, ...)), as the reference orders it.
    scan=True: the 4 offsets one after another — 4x lower activation
    peak.
    """
    if scan:
        return torch.stack([query_sigma(p)[..., 0] for p in new_pts])
    b = new_pts.shape[1]
    pts_bmajor = new_pts.transpose(0, 1).reshape(4 * b, *new_pts.shape[2:])
    sigma = query_sigma(pts_bmajor)[..., 0]
    return sigma.reshape(b, 4, -1).transpose(0, 1)


def normal_from_depth_gradient_epsilon(query_sigma, rays_o, rays_d, z_vals,
                                       epsilon: float = 0.01,
                                       scan: bool = False):
    """Finite-difference normals wrt *position* offsets."""
    right, up = _pixel_basis(rays_d)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]

    offsets = torch.stack([right, -right, up, -up], dim=0)  # (4, B, 3)
    new_pts = pts[None] + epsilon * offsets[:, :, None, :]  # (4, B, S, 3)
    sigma = _sweep_sigma(query_sigma, new_pts, scan)

    dists = dists_from_z_vals(z_vals, rays_d)
    d_r, d_l, d_u, d_d = (_depth_from_sigma(sigma[i], dists, z_vals)
                          for i in range(4))
    dx = 2 * epsilon * right + (d_r - d_l)[..., None] * rays_d
    dy = 2 * epsilon * up + (d_u - d_d)[..., None] * rays_d
    return _normalize(torch.linalg.cross(dx, dy, dim=-1))


def normal_from_depth_gradient_direction_epsilon(query_sigma, rays_o, rays_d,
                                                 z_vals, epsilon: float = 0.01,
                                                 scan: bool = False):
    """Finite-difference normals wrt *direction* offsets."""
    right, up = _pixel_basis(rays_d)
    nd = [_normalize(rays_d + epsilon * right),
          _normalize(rays_d - epsilon * right),
          _normalize(rays_d + epsilon * up),
          _normalize(rays_d - epsilon * up)]

    new_d = torch.stack(nd, dim=0)                              # (4, B, 3)
    pts = (rays_o[None, :, None, :]
           + new_d[:, :, None, :] * z_vals[None, :, :, None])   # (4, B, S, 3)
    sigma = _sweep_sigma(query_sigma, pts, scan)

    dists = dists_from_z_vals(z_vals, rays_d)
    pos = [rays_o + _depth_from_sigma(sigma[i], dists, z_vals)[..., None] * nd[i]
           for i in range(4)]
    return _normalize(torch.linalg.cross(pos[0] - pos[1], pos[2] - pos[3], dim=-1))
