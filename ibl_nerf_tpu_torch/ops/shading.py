"""Physically based shading: the split-sum pieces (roughness-aware
Fresnel, reflect) and the full GGX microfacet BRDF of the Monte-Carlo
estimator.

Counterpart of ibl_nerf_tpu/ops/shading.py.
"""

from __future__ import annotations

import numpy as np
import torch

_BIAS = 1e-5


def fresnel_schlick_roughness(
    cos_theta: torch.Tensor, f0: torch.Tensor, roughness: torch.Tensor
) -> torch.Tensor:
    """Roughness-aware Schlick Fresnel.

    cos_theta: (...,); f0: (..., 3); roughness: (...,). Returns (..., 3).
    """
    cos_theta = cos_theta[..., None]
    roughness = roughness[..., None]
    f1 = torch.maximum(1.0 - roughness, f0) - f0
    return f0 + f1 * torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect direction d about normal n (both (..., 3))."""
    return d - 2.0 * torch.sum(n * d, dim=-1, keepdim=True) * n


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def ggx_distribution(m: torch.Tensor, n: torch.Tensor, alpha) -> torch.Tensor:
    """GGX normal distribution D. m: (N, L, 3) half vectors; n: (N, 3)."""
    cos_tm = torch.clamp(torch.einsum("ijk,ik->ij", m, n), 0.0, 1.0)
    a2 = alpha**2
    denom = np.pi * torch.square(torch.square(cos_tm) * (a2 - 1.0) + 1.0)
    return a2 / (denom + _BIAS)


def _g_ggx(n_dot_x, r):
    k = r * r / 2.0
    return n_dot_x / (n_dot_x * (1.0 - k) + k + _BIAS)


def ggx_geometry(n_dot_v: torch.Tensor, n_dot_l: torch.Tensor, alpha) -> torch.Tensor:
    """Smith geometry term (product of the view and light GGX terms)."""
    return _g_ggx(n_dot_l, alpha) * _g_ggx(n_dot_v, alpha)


def schlick_fresnel(l: torch.Tensor, m: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """Schlick Fresnel. l, m: (N, L, 3); f0: (N, 3) -> (N, L, 3)."""
    cos_theta = torch.clamp(torch.einsum("ijk,ijk->ij", l, m), 0.0, 1.0)[..., None]
    f0 = f0[:, None, :]
    return f0 + (1.0 - f0) * (1.0 - cos_theta) ** 5


def microfacet_brdf(
    pts2l: torch.Tensor,
    pts2c: torch.Tensor,
    normal: torch.Tensor,
    albedo: torch.Tensor | None = None,
    rough: torch.Tensor | None = None,
    f0_scalar: float = 0.04,
    default_rough: float = 0.3,
):
    """The full GGX microfacet BRDF: (glossy (N, L, 3), diffuse (N, L, 3),
    l.n (N, L, 1)).

    pts2l: (N, L, 3) surface-to-light dirs; pts2c: (N, 3) to the camera;
    normal and albedo: (N, 3); rough: (N, 1). Dielectric f0 with
    metallic = 1 - roughness, alpha = roughness^2.
    """
    n = pts2c.shape[0]
    if albedo is None:
        albedo = pts2c.new_ones((n, 3))
    if rough is None:
        rough = pts2c.new_full((n, 1), default_rough)

    pts2l = _normalize(pts2l)
    pts2c = _normalize(pts2c)
    normal = _normalize(normal)

    h = _normalize(pts2l + pts2c[:, None, :])
    metallic = 1.0 - rough
    f0 = f0_scalar * (1.0 - metallic) + albedo * metallic
    f = schlick_fresnel(pts2l, h, f0)
    alpha = rough**2

    l_dot_n = torch.clamp(torch.einsum("ijk,ik->ij", pts2l, normal), 0.0, 1.0)
    v_dot_n = torch.clamp(torch.einsum("ij,ij->i", pts2c, normal), 0.0, 1.0)[..., None]

    d = ggx_distribution(h, normal, alpha)[..., None]
    g = ggx_geometry(v_dot_n, l_dot_n, alpha)[..., None]
    denom = (4.0 * l_dot_n * v_dot_n)[..., None]

    brdf_glossy = f * g * d / (denom + _BIAS)
    lambert = albedo / np.pi
    brdf_diffuse = (1.0 - f) * lambert[:, None, :] * (1.0 - metallic[..., None])
    return brdf_glossy, brdf_diffuse, l_dot_n[..., None]
