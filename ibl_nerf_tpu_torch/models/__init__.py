"""Neural field and auxiliary heads (dict-of-tensor params + pure apply
functions)."""

from ibl_nerf_tpu_torch.models.field import (
    FieldConfig,
    init_field_params,
    apply_field,
    apply_field_density,
    field_raw_channels,
)
from ibl_nerf_tpu_torch.models.aux_mlp import (
    init_position_mlp,
    apply_position_mlp,
    init_position_direction_mlp,
    apply_position_direction_mlp,
)
