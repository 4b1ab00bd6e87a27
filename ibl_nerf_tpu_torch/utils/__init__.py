"""Utilities: device selection, weight conversion, logging, the PNG
encoder, video export and mesh extraction."""

from ibl_nerf_tpu_torch.utils.device import pin_f32_matmul, resolve_device
from ibl_nerf_tpu_torch.utils.port import (
    field_params_from_numpy,
    field_params_from_torch_state,
    load_reference_checkpoint,
    position_direction_mlp_params_from_torch_state,
    position_mlp_params_from_torch_state,
)
