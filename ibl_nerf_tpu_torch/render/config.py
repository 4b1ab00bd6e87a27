"""Static renderer configuration.

Counterpart of ibl_nerf_tpu/render/config.py: the same frozen
dataclasses with the same field names, so a config converts field by
field. Which of the modes the port covers is checked by
`render.renderer.render_rays`.
"""

from __future__ import annotations

import dataclasses

from ibl_nerf_tpu_torch.models.field import FieldConfig


NORMAL_TYPES = (
    "ground_truth",
    "inferred_normal_map",
    "normal_map_from_depth_gradient",
    "normal_map_from_depth_gradient_epsilon",
    "normal_map_from_depth_gradient_direction",
    "normal_map_from_depth_gradient_direction_epsilon",
    "normal_map_from_sigma_gradient",
    "normal_map_from_sigma_gradient_surface",
)


@dataclasses.dataclass(frozen=True)
class EditConfig:
    """Material-edit / object-insertion configuration."""

    mode: str = "edit"  # "edit" | "insert"
    num_objects: int = 1
    edit_normal: bool = False
    edit_albedo: bool = False
    edit_albedo_by_img: bool = False
    edit_roughness: bool = False
    edit_roughness_by_img: bool = False
    edit_depth: bool = False
    # Per-object constant overrides (flattened rgb triples for albedo).
    target_albedo: tuple[float, ...] = ()
    target_roughness: tuple[float, ...] = ()
    target_irradiance: tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All static knobs of one render mode."""

    field: FieldConfig = FieldConfig()
    # Distinct fine-network architecture (None = same as coarse); must
    # share multires/coarse_radiance_number with `field`.
    field_fine: FieldConfig | None = None

    # sampling
    n_samples: int = 64
    n_importance: int = 128
    perturb: bool = True
    lindisp: bool = False
    raw_noise_std: float = 0.0

    # radiance parameterization / output transforms
    use_radiance_linear: bool = False
    gamma_correct: bool = False

    # shading estimator under approximate_radiance: "split_sum" |
    # "monte_carlo"
    shading_mode: str = "split_sum"
    mc_samples_axis: int = 3

    # split-sum shading
    approximate_radiance: bool = False
    normal_type: str = "ground_truth"
    epsilon: float = 0.01
    epsilon_direction: float = 0.005
    lut_coefficient: str = "F"  # "F" | "F0"
    correct_depth_for_prefiltered_radiance_infer: bool = False
    use_gradient_for_incident_radiance: bool = False

    # gt substitutions
    depth_map_from_ground_truth: bool = False
    calculate_albedo_from_gt: bool = False
    calculate_roughness_from_gt: bool = False
    calculate_irradiance_from_gt: bool = False

    # staged freezing (gradient-only: no effect on a forward render)
    freeze_radiance: bool = False
    freeze_roughness: bool = False

    # aux heads
    infer_normal: bool = False
    infer_normal_at_surface: bool = False
    infer_depth: bool = False
    infer_albedo_separate: bool = False
    infer_roughness_separate: bool = False
    infer_irradiance_separate: bool = False

    # editing / insertion
    edit: EditConfig | None = None

    # numerics / kernels
    # "float32" | "bfloat16" | "mixed" | "bf16_grad" | "amp" | "float64"
    # -- see renderer.FieldQueries for the split
    compute_dtype: str = "float32"
    use_pallas: bool = False        # fused-field kernel K1 on no-grad sweeps
    use_pallas_train: bool = False  # fused train kernels K2/K3 (bf16 gradient path)

    # inference fast path: coarse pass density-only (weights for the
    # importance resample + depth); every fine buffer is unchanged.
    coarse_shading: bool = True
    # run the 4 ε-offset depth sweeps one after another instead of as
    # one 4B-batched query: 4x lower activation peak.
    sweep_scan: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def prefiltered_levels(self) -> int:
        return 1 + self.field.coarse_radiance_number
