"""Auxiliary head MLPs.

Counterpart of ibl_nerf_tpu/models/aux_mlp.py:
 - PositionMLP: a position-only trunk (skip at 4) and a linear out; the
   normal, albedo, roughness and irradiance heads.
 - PositionDirectionMLP: the trunk, a feature layer, a W//2-wide view
   branch of D//2 layers and a linear out; the depth and visibility
   heads.

Params are dicts of (in, out) tensors mirroring the JAX pytree, drawn
from a numpy generator as `models/field.init_field_params` draws the
field; the skip indices are a function argument. The matmuls run in the
dtype of the inputs, outside any kernel, as JAX computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ibl_nerf_tpu_torch.models.field import Params, _dense, _linear_init
from ibl_nerf_tpu_torch.utils.device import resolve_device

SKIPS = (4,)


def _trunk_fan_ins(depth: int, width: int, input_ch: int, skips) -> list[int]:
    return [input_ch if i == 0 else (width + input_ch if (i - 1) in skips else width)
            for i in range(depth)]


def init_position_mlp(rng: np.random.Generator, depth: int = 8, width: int = 256,
                      input_ch: int = 63, out_ch: int = 3, skips=SKIPS,
                      device: str | torch.device | None = None) -> Params:
    """Random params drawn from `rng` (trunk, then out), on `device`
    (CUDA unless the caller names another)."""
    device = resolve_device(device)
    trunk = [_linear_init(rng, f, width, device)
             for f in _trunk_fan_ins(depth, width, input_ch, skips)]
    return {"trunk": trunk, "out": _linear_init(rng, width, out_ch, device)}


def _apply_trunk(params: Params, pts_emb: torch.Tensor, skips) -> torch.Tensor:
    h = pts_emb
    for i, layer in enumerate(params["trunk"]):
        h = torch.relu(_dense(layer, h))
        if i in skips:
            h = torch.cat([pts_emb, h], dim=-1)
    return h


def apply_position_mlp(params: Params, pts_emb: torch.Tensor, skips=SKIPS) -> torch.Tensor:
    return _dense(params["out"], _apply_trunk(params, pts_emb, skips))


def init_position_direction_mlp(rng: np.random.Generator, depth: int = 8,
                                width: int = 256, input_ch: int = 63,
                                input_ch_views: int = 27, out_ch: int = 1,
                                skips=SKIPS,
                                device: str | torch.device | None = None) -> Params:
    """Random params drawn from `rng` in JAX's order (trunk, views,
    feature, out), on `device` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    trunk = [_linear_init(rng, f, width, device)
             for f in _trunk_fan_ins(depth, width, input_ch, skips)]
    views = [_linear_init(rng, input_ch_views + width, width // 2, device)]
    views += [_linear_init(rng, width // 2, width // 2, device)
              for _ in range(depth // 2 - 1)]
    return {
        "trunk": trunk,
        "feature": _linear_init(rng, width, width, device),
        "views": views,
        "out": _linear_init(rng, width // 2, out_ch, device),
    }


def apply_position_direction_mlp(params: Params, pts_emb: torch.Tensor,
                                 dirs_emb: torch.Tensor, skips=SKIPS) -> torch.Tensor:
    feat = _dense(params["feature"], _apply_trunk(params, pts_emb, skips))
    h2 = torch.cat([feat, dirs_emb], dim=-1)
    for layer in params["views"]:
        h2 = torch.relu(_dense(layer, h2))
    return _dense(params["out"], h2)
