"""Pre-integrated split-sum environment-BRDF LUT.

Counterpart of ibl_nerf_tpu/data/brdf_lut.py. The port ships its own
copy of the asset as raw uint8 RGB (`ibl_brdf_lut.npy`, (512, 512, 3),
made once from ibl_nerf_tpu/data/ibl_brdf_lut.png), so reading it needs
numpy only — no image codec.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ibl_nerf_tpu_torch.utils.device import resolve_device

_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "ibl_brdf_lut.npy")


def load_brdf_lut(path: str | None = None,
                  device: str | torch.device | None = None) -> torch.Tensor:
    """The LUT as an (H, W, 3) f32 tensor in [0, 1] (RGB order) on
    `device` (CUDA unless named)."""
    device = resolve_device(device)
    img = np.load(path or _DEFAULT_PATH)
    return torch.from_numpy(img.astype(np.float32) / 255.0).to(device)
