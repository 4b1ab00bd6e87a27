"""Weight conversion into the port's field and aux-head params.

Two sources: a PyTorch reference IBL-NeRF state_dict (the field's or an
aux MLP's) or its `.tar` checkpoint (Linear weights (out, in),
counterpart of ibl_nerf_tpu/utils/port.py), and a JAX param pytree
already turned into numpy arrays (same (in, out) layout; any tree of
dicts and lists, the aux heads' and the environment map's too).
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


def _lin(sd: dict, name: str, device: torch.device) -> dict:
    """A Linear layer of a state_dict, transposed to (in, out)."""
    return {"w": _tensor(_np(sd[f"{name}.weight"]).T, device),
            "b": _tensor(sd[f"{name}.bias"], device)}


def field_params_from_numpy(tree: Any,
                            device: str | torch.device | None = None) -> Any:
    """A JAX param pytree (dicts/lists of numpy arrays: the fields, the
    aux heads, {"emission": ...}) as the same structure of f32 tensors
    on `device` (CUDA unless named)."""
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
        return _lin(sd, name, device)

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


def position_mlp_params_from_torch_state(sd: dict, depth: int = 8,
                                         device: str | torch.device | None = None):
    """A reference PositionMLP state_dict as the port's params."""
    device = resolve_device(device)
    return {"trunk": [_lin(sd, f"positions_linears.{i}", device) for i in range(depth)],
            "out": _lin(sd, "out_linears", device)}


def position_direction_mlp_params_from_torch_state(
        sd: dict, depth: int = 8, device: str | torch.device | None = None):
    """A reference PositionDirectionMLP state_dict as the port's params."""
    device = resolve_device(device)
    return {"trunk": [_lin(sd, f"positions_linears.{i}", device) for i in range(depth)],
            "feature": _lin(sd, "feature_linear", device),
            "views": [_lin(sd, f"views_linears.{i}", device) for i in range(depth // 2)],
            "out": _lin(sd, "final_linear", device)}


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
