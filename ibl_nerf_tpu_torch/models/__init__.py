"""Neural field (dict-of-tensor params + pure apply functions)."""

from ibl_nerf_tpu_torch.models.field import (
    FieldConfig,
    init_field_params,
    apply_field,
    apply_field_density,
    field_raw_channels,
)
