"""Volumetric alpha-compositing primitives.

Counterpart of ibl_nerf_tpu/ops/compositing.py: alpha = 1 -
exp(-relu(sigma_raw) * dist), transmittance = exclusive cumprod of
(1 - alpha + 1e-10), weights = alpha * T.
"""

from __future__ import annotations

import torch

INF_DIST = 1e10
TRANSMITTANCE_EPS = 1e-10


def dists_from_z_vals(z_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Inter-sample distances, last one infinite, scaled by |rays_d|.

    z_vals: (..., S); rays_d: (..., 3) -> (..., S)
    """
    d = z_vals[..., 1:] - z_vals[..., :-1]
    d = torch.cat([d, torch.full_like(d[..., :1], INF_DIST)], dim=-1)
    return d * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)


def alpha_from_sigma(sigma_raw: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """alpha = 1 - exp(-relu(sigma_raw) * dist)."""
    return 1.0 - torch.exp(-torch.relu(sigma_raw) * dists)


def _exclusive(t_full: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(t_full[..., :1]), t_full[..., :-1]], dim=-1)


def weights_from_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """weights_i = alpha_i * prod_{j<i}(1 - alpha_j + eps)."""
    t = torch.cumprod(1.0 - alpha + TRANSMITTANCE_EPS, dim=-1)
    return alpha * _exclusive(t)


def transmittance_and_weights(alpha: torch.Tensor):
    """Returns (weights, final_visibility): final_visibility is the
    transmittance past the last sample."""
    t_full = torch.cumprod(1.0 - alpha + TRANSMITTANCE_EPS, dim=-1)
    return alpha * _exclusive(t_full), t_full[..., -1]


def accumulate(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the sample axis.

    weights: (..., S); values: (..., S) or (..., S, C).
    """
    if values.ndim == weights.ndim:
        return torch.sum(weights * values, dim=-1)
    # einsum does not promote, jnp.einsum does (f64 weights over the f32 raw
    # of K1 at f64 weights)
    dt = torch.promote_types(weights.dtype, values.dtype)
    return torch.einsum("...s,...sc->...c", weights.to(dt), values.to(dt))


def composite_depth_disp_acc(weights: torch.Tensor, z_vals: torch.Tensor):
    """depth / disparity / accumulated-opacity maps."""
    depth = torch.sum(weights * z_vals, dim=-1)
    acc = torch.sum(weights, dim=-1)
    disp = 1.0 / torch.clamp(depth / acc, min=1e-10)
    return depth, disp, acc
