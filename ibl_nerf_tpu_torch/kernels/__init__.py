"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain
PyTorch versions."""

from ibl_nerf_tpu_torch.kernels.fused_field import (
    pack_field_weights,
    fused_field_apply,
    fused_field_density,
    fused_field_apply_plain,
    fused_field_density_plain,
)
