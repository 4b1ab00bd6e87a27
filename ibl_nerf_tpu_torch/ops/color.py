"""Color-space transforms and image metrics helpers.

Counterpart of ibl_nerf_tpu/ops/color.py: the gamma encode, tonemap and
radiance activation on tensors, `to8b` and the piecewise sRGB
transforms in numpy (the same numpy calls as JAX's, so bit-exact).
"""

from __future__ import annotations

import math

import numpy as np
import torch

GAMMA = 2.2
EPSILON_SRGB = 1e-12


def rgb_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """Simple power-law gamma encode: (x + eps)^(1/2.2)."""
    return torch.pow(x + EPSILON_SRGB, 1.0 / GAMMA)


def tonemap_reinhard(x: torch.Tensor) -> torch.Tensor:
    return x / (x + 1.0)


def hdr_radiance_activation(x: torch.Tensor) -> torch.Tensor:
    """relu radiance activation used when `use_radiance_linear` is on."""
    return torch.relu(x)


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


# Piecewise (IEC 61966-2-1) sRGB transforms, numpy variants for data I/O.
def linear_to_srgb_np(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1 / 2.4) - 0.055)


def srgb_to_linear_np(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.04045, x / 12.92, np.power((x + 0.055) / 1.055, 2.4))
