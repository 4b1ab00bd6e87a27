"""Stratified + hierarchical (inverse-CDF) ray sampling.

Counterpart of ibl_nerf_tpu/ops/sampling.py. Where the JAX functions
take a PRNG key, these take the uniform draws `u` themselves, so a test
can hand both sides the same numbers.
"""

from __future__ import annotations

import torch


def stratified_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    lindisp: bool = False,
    perturb: bool = False,
    u: torch.Tensor | None = None,
) -> torch.Tensor:
    """Coarse z samples: linspace in depth (or disparity), optionally
    jittered within each stratum by the uniform draws `u` (shape of the
    result).

    near/far: (..., 1) -> z_vals (..., n_samples).
    """
    t = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype,
                       device=near.device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    if perturb:
        if u is None:
            raise ValueError("perturb=True needs the uniform draws u")
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        z = lower + (upper - lower) * u
    return z


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    u: torch.Tensor | None = None,
) -> torch.Tensor:
    """Inverse-CDF importance sampling of ``n_samples`` new z values.

    bins: (B, M) bin centers; weights: (B, M-1). Returns (B, n_samples).
    searchsorted(cdf, u, right=True) with below/above clamping and the
    degenerate-interval guard (denom < 1e-5). det=False takes the draws
    `u` (B, n_samples).
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (B, M)

    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device)
        u = u.expand(*cdf.shape[:-1], n_samples)
    elif u is None:
        raise ValueError("det=False needs the uniform draws u")
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
