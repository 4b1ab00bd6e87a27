"""Color-space transforms.

Counterpart of ibl_nerf_tpu/ops/color.py (`rgb_to_srgb`,
`tonemap_reinhard`, `to8b`).
"""

from __future__ import annotations

import numpy as np
import torch

GAMMA = 2.2
EPSILON_SRGB = 1e-12


def rgb_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """Simple power-law gamma encode: (x + eps)^(1/2.2)."""
    return torch.pow(x + EPSILON_SRGB, 1.0 / GAMMA)


def tonemap_reinhard(x: torch.Tensor) -> torch.Tensor:
    return x / (x + 1.0)


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)
