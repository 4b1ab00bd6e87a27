"""Weight conversion into the port's field params.

Two sources: a PyTorch reference IBL-NeRF state_dict or its `.tar`
checkpoint (Linear weights (out, in), counterpart of
ibl_nerf_tpu/utils/port.py), and a JAX field pytree already turned into
numpy arrays (same (in, out) layout).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ibl_nerf_tpu_torch.utils.device import resolve_device


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a), dtype=np.float32)).to(device)


def field_params_from_numpy(tree: Any,
                            device: str | torch.device | None = None) -> Any:
    """A JAX field pytree (dicts/lists of numpy arrays) as the same
    structure of f32 tensors on `device` (CUDA unless named)."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _tensor(x, device)

    return conv(tree)


def field_params_from_torch_state(sd: dict, coarse_radiance_number: int = 3,
                                  depth: int = 8,
                                  device: str | torch.device | None = None):
    """Map an IBLNeRF state_dict (tensors or numpy arrays) to the port's
    field params."""
    device = resolve_device(device)

    def lin(name):
        return {"w": _tensor(_np(sd[f"{name}.weight"]).T, device),
                "b": _tensor(sd[f"{name}.bias"], device)}

    return {
        "trunk": [lin(f"positions_linears.{i}") for i in range(depth)],
        "sigma": lin("sigma_linear"),
        "albedo_feat": lin("albedo_feature_linear"),
        "albedo": lin("albedo_linear"),
        "roughness": lin("roughness_linear"),
        "irradiance_feat": lin("irradiance_feature_linear"),
        "irradiance": lin("irradiance_linear"),
        "feature": lin("feature_linear"),
        "views": [lin("views_linears.0")],
        "radiance": lin("radiance_linear"),
        "coarse_feat": [lin(f"additional_radiance_feature_linear.{i}")
                        for i in range(coarse_radiance_number)],
        "coarse": [lin(f"additional_radiance_linear.{i}")
                   for i in range(coarse_radiance_number)],
    }


def load_reference_checkpoint(path: str, coarse_radiance_number: int = 3,
                              depth: int = 8, device: str | torch.device | None = None):
    """Read a reference `.tar` checkpoint into (coarse, fine, step,
    elapsed): the field params on `device` (CUDA unless named), fine
    None when the checkpoint has no fine network."""
    ckpt = torch.load(path, map_location="cpu")
    coarse = field_params_from_torch_state(ckpt["network_fn_state_dict"],
                                           coarse_radiance_number, depth, device)
    fine = None
    if ckpt.get("network_fine_state_dict"):
        fine = field_params_from_torch_state(ckpt["network_fine_state_dict"],
                                             coarse_radiance_number, depth, device)
    return coarse, fine, ckpt.get("global_step", 0), ckpt.get("elapsed_time", 0.0)
