"""Split-sum shading pieces.

Counterpart of the split-sum part of ibl_nerf_tpu/ops/shading.py
(`fresnel_schlick_roughness`, `reflect`). The GGX microfacet BRDF of
the Monte-Carlo estimator is not ported yet.
"""

from __future__ import annotations

import torch


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
