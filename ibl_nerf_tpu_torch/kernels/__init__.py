"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain
PyTorch versions."""

from ibl_nerf_tpu_torch.kernels.fused_field import (
    pack_field_weights,
    fused_field_apply,
    fused_field_density,
    fused_field_apply_plain,
    fused_field_density_plain,
)
from ibl_nerf_tpu_torch.kernels.fused_field_train import (
    FusedFieldTrain,
    fused_field_apply_train,
    train_backward_plain,
    train_forward_plain,
)
