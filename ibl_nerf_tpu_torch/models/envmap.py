"""Learnable environment map.

Counterpart of ibl_nerf_tpu/models/envmap.py: a (2n, n, 3) emission
texture with a direction -> canonical-UV mapping and a bilinear lookup.
The reference trains it as an optimizer group under
`use_environment_map` but its renderer never reads it, and neither does
the JAX renderer nor this one: the init, the lookup and the group are
what is ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ibl_nerf_tpu_torch.ops.texture import grid_sample_2d
from ibl_nerf_tpu_torch.utils.device import resolve_device


def init_envmap(rng: np.random.Generator, n: int = 16,
                device: str | torch.device | None = None) -> dict:
    """Emission texture params {'emission': (2n, n, 3)} (HWC), uniform in
    [0, 0.1), drawn from `rng`, on `device` (CUDA unless named)."""
    device = resolve_device(device)
    e = rng.uniform(0.0, 1.0, (2 * n, n, 3)).astype(np.float32) * np.float32(0.1)
    return {"emission": torch.from_numpy(e).to(device)}


def direction_to_canonical(dirs: torch.Tensor) -> torch.Tensor:
    """Unit directions to [-1, 1]^2 UV: u = atan2(y, x)/pi,
    v = 2 acos(z)/pi - 1 (equirectangular)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    u = torch.atan2(y, x) / np.pi
    v = 2.0 * torch.arccos(torch.clamp(z, -1.0, 1.0)) / np.pi - 1.0
    return torch.stack([u, v], dim=-1)


def sample_envmap(params: dict, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear emission lookup along directions (..., 3) -> (..., 3)."""
    norm = torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
    return grid_sample_2d(params["emission"], direction_to_canonical(dirs / norm))
