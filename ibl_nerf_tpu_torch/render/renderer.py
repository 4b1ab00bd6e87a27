"""The volumetric renderer: hierarchical sampling, intrinsic
compositing, and split-sum image-based-lighting shading.

Counterpart of ibl_nerf_tpu/render/renderer.py: the coarse pass (full
shading in training, density-only on the `coarse_shading=False` fast
path), `sample_pdf`, and the fine pass with ε, depth-gradient, sgs, gt
or inferred normals, then split-sum shading (the BRDF-LUT fetch and
Fresnel, the reflected march, `mip_interp` and the diffuse + specular
combine) or Monte-Carlo shading (GGX over `mc_samples_axis`² hemisphere
directions, each marched for its incident radiance); the aux heads
(`models/aux_mlp`: the inferred normal, the separate albedo, roughness
and irradiance, the inferred depth); the gt inputs (`gt_values`: the
`ground_truth` normal, `depth_map_from_ground_truth` and the
`calculate_*_from_gt` substitutions) and the material-edit and
object-insert overrides (`RenderConfig.edit`: gray-level object masks,
the edit/insert depth before the surface point, the normal, albedo,
roughness and irradiance overrides before the LUT fetch). Gradients
follow the JAX renderer's `stop_gradient` sites: intrinsic maps on
detached weights (radiance on live ones), a detached surface point, a
detached reflected march and detached depth in the mip level. The
no-grad sweeps run under `torch.no_grad()`.

Every field query goes through `FieldQueries`, which picks the
implementation and dtype of each: with `use_pallas` the no-grad sweeps
(ε-offset density sweeps, reflected march, Monte-Carlo incident march)
run the fused-field kernel K1 (`kernels/fused_field.py`), each march on
the heads it reads; with `use_pallas_train` and bf16 gradients the
gradient-path full query runs K2/K3 (`kernels/fused_field_train.py`), as
the JAX renderer routes them through its Pallas kernels. A training
pass builds its own; a frame
(`make_frame_render_fn` + `render_frame`, which `render_image` runs too)
renders under no-grad, one chunk after another, on queries built once
for the frame. Random draws (the `perturb` jitter and
importance uniforms, the `raw_noise_std` noise on raw σ) come from a
`torch.Generator` or are passed in. Under `compute_dtype=float64` K1
runs at f64 weights (`csrc/fused_field_f64.cu`) and returns f32 raw, as
the JAX kernel does. With spans on (`utils/timing`) the passes are the
spans `render.coarse`, `render.importance` and `render.fine`, and inside
a shaded pass `render.aux_heads`, `render.normal` and `render.shading`
(under Monte-Carlo shading `render.mc_incident` and `render.mc_brdf`
inside it); the inferred depth head is `render.depth_head`. `COUNTERS`
counts the points of the Monte-Carlo incident marches and of the ε-normal
density sweeps, on every device.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from ibl_nerf_tpu_torch.kernels.fused_field import (
    fused_field_apply,
    fused_field_density,
    pack_field_weights,
    radiance_column,
    select_heads,
)
from ibl_nerf_tpu_torch.kernels.fused_field_train import fused_field_apply_train, to_bf16
from ibl_nerf_tpu_torch.models.aux_mlp import apply_position_direction_mlp, apply_position_mlp
from ibl_nerf_tpu_torch.models.field import apply_field, apply_field_density
from ibl_nerf_tpu_torch.ops.color import rgb_to_srgb, tonemap_reinhard
from ibl_nerf_tpu_torch.ops.compositing import (
    accumulate,
    alpha_from_sigma,
    composite_depth_disp_acc,
    dists_from_z_vals,
    transmittance_and_weights,
    weights_from_alpha,
)
from ibl_nerf_tpu_torch.ops.embedding import positional_encoding
from ibl_nerf_tpu_torch.ops.geometry import get_tbn, hemisphere_samples
from ibl_nerf_tpu_torch.ops.rays import get_rays_full_image
from ibl_nerf_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals
from ibl_nerf_tpu_torch.ops.shading import fresnel_schlick_roughness, microfacet_brdf, reflect
from ibl_nerf_tpu_torch.ops.texture import grid_sample_2d, mip_interp
from ibl_nerf_tpu_torch.render import normals as normals_mod
from ibl_nerf_tpu_torch.render.config import NORMAL_TYPES, RenderConfig
from ibl_nerf_tpu_torch.utils.device import pin_f32_matmul
from ibl_nerf_tpu_torch.utils.timing import span

_AUTOGRAD_NORMALS = ("normal_map_from_depth_gradient",
                     "normal_map_from_depth_gradient_direction")

# points queried by the Monte-Carlo incident marches (B·M·S a march) and by
# the ε-normal density sweeps (4·B·S a sweep), kept beside the kernels'
# launch counters (`kernels/*.LAUNCHES`)
COUNTERS = {"mc_incident_points": 0, "eps_normal_points": 0}

# compute_dtype -> (gradient-path dtype, no-grad sweep dtype)
_QUERY_DTYPES = {"float32": (torch.float32, torch.float32),
                 "bfloat16": (torch.bfloat16, torch.bfloat16),
                 "mixed": (torch.float32, torch.bfloat16),
                 "bf16_grad": (torch.bfloat16, torch.float32),
                 "amp": (torch.float32, torch.float32),
                 "float64": (torch.float64, torch.float64)}


def _check_supported(rcfg: RenderConfig) -> None:
    """Raise ValueError for an unknown compute dtype or normal type."""
    if rcfg.compute_dtype not in _QUERY_DTYPES:
        raise ValueError(f"unknown compute_dtype {rcfg.compute_dtype!r}")
    if rcfg.approximate_radiance and rcfg.normal_type not in NORMAL_TYPES:
        raise ValueError(f"unknown normal_type {rcfg.normal_type!r}")


# ---------------------------------------------------------------------------
# Field queries
# ---------------------------------------------------------------------------

def pallas_train_refusal(rcfg: RenderConfig) -> str | None:
    """Why K2/K3 cannot take the gradient path's full query of
    `rcfg.field` (use_pallas_train then runs the eager query), or None
    when they can: they hold bf16 queries of the default 8-layer field
    with its skip at layer 4 and view-dependent colour, with nothing
    frozen."""
    fcfg = rcfg.field
    dt_grad = _QUERY_DTYPES[rcfg.compute_dtype][0]
    if dt_grad != torch.bfloat16:
        return (f"dtype: compute_dtype {rcfg.compute_dtype} runs the gradient path in "
                f"{str(dt_grad).removeprefix('torch.')}, K2/K3 in bfloat16")
    if rcfg.freeze_radiance:
        return "freeze: the radiance heads are frozen in this phase"
    if fcfg.depth != 8:
        return f"depth: netdepth {fcfg.depth}, K2/K3 hold 8 layers"
    if fcfg.skips != (4,):
        return f"skips: {fcfg.skips}, K2/K3 hold one skip at layer 4"
    if fcfg.color_independent_to_direction:
        return "view dependence: color_independent_to_direction, K2/K3 read view directions"
    return None


class FieldQueries:
    """The four queries of one field under `rcfg`: `full(pts, viewdirs)`
    and `sigma(pts)` on the gradient path, `full_ng` and `sigma_ng` for
    the no-grad sweeps (call those under torch.no_grad()). `full_ng` takes
    the head set its march reads (`kernels/fused_field.HEAD_SETS`) and
    returns those raw columns; K1 at f32 weights computes only them.

    compute_dtype, as in the JAX renderer: "float32" everything f32;
    "bfloat16" every query in bf16 (f32 raw heads); "mixed" the gradient
    path f32, the no-grad sweeps (ε-normals, reflected march) bf16;
    "bf16_grad" the inverse split; "amp" f32 everywhere but the matmul
    operands, rounded to bf16 and summed in f32, with the no-grad sweeps
    in plain f32; "float64" everything f64. With use_pallas the `_ng`
    pair is K1 at the no-grad dtype, fed detached weights. With
    use_pallas_train and no `pallas_train_refusal`, `full` is K2/K3,
    whose gradients flow through the f32 packing to the params (positions
    get none); `sigma` stays eager, since the sgs normal needs its
    position gradient.

    Each cast and pack is made on first use, at most once per instance,
    in the grad mode the instance was built in. A training pass builds
    its own, so no bf16 cast carries the gradients of two passes; a frame
    builds one per field under torch.no_grad() (`frame_queries`), and its
    K2 weights are then packed already rounded to bf16. With K2 on, K1's
    pack is K2's f32 pack, detached, at the no-grad dtype.
    """

    def __init__(self, field_params, rcfg: RenderConfig):
        self.params, self.rcfg, self.fcfg = field_params, rcfg, rcfg.field
        self.dt_grad, self.dt_ng = _QUERY_DTYPES[rcfg.compute_dtype]
        self.amp = rcfg.compute_dtype == "amp"
        self.k2 = rcfg.use_pallas_train and pallas_train_refusal(rcfg) is None
        self.grad = torch.is_grad_enabled()
        self._casts: dict[torch.dtype, Any] = {}

    def full(self, pts, viewdirs):
        if self.k2:
            return fused_field_apply_train(self._k2_pack, pts, viewdirs, self.fcfg)
        return self._eager(self.dt_grad, self.amp, pts, viewdirs)

    def sigma(self, pts):
        return self._eager(self.dt_grad, self.amp, pts)

    def full_ng(self, pts, viewdirs, heads: str = "all"):
        if self.rcfg.use_pallas:
            return fused_field_apply(self._k1_pack, pts, viewdirs, self.fcfg, heads)
        return select_heads(self._eager(self.dt_ng, False, pts, viewdirs), heads)

    def sigma_ng(self, pts):
        if self.rcfg.use_pallas:
            return fused_field_density(self._k1_pack, pts, self.fcfg)
        return self._eager(self.dt_ng, False, pts)

    def _cast(self, dt: torch.dtype):
        """The params cast to `dt`, in the grad mode of the instance."""
        def cast(tree):
            if isinstance(tree, dict):
                return {k: cast(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [cast(v) for v in tree]
            return tree.to(dt)
        with torch.set_grad_enabled(self.grad):
            return cast(self.params)

    def _eager(self, dt: torch.dtype, amp: bool, pts, viewdirs=None):
        """apply_field (apply_field_density without viewdirs) at `dt`; under
        `amp`, f32 with bf16 matmul operands. pts (B, S, 3); viewdirs (B, 3)
        broadcast over samples. The encoding runs in the points' dtype, then
        is cast to `dt`; raw is f32 for bf16 compute and `dt` otherwise."""
        if dt != torch.float32 and dt not in self._casts:
            self._casts[dt] = self._cast(dt)
        params, fcfg, rc = self._casts.get(dt, self.params), self.fcfg, self.rcfg
        pe = positional_encoding(pts, fcfg.multires).to(dt)
        if viewdirs is None:
            out = apply_field_density(params, pe, fcfg, freeze_radiance=rc.freeze_radiance,
                                      amp=amp)
        else:
            de = positional_encoding(viewdirs, fcfg.multires_views).to(dt)
            de = de[..., None, :].expand(*pts.shape[:-1], de.shape[-1])
            out = apply_field(params, pe, de, fcfg, freeze_radiance=rc.freeze_radiance,
                              freeze_roughness=rc.freeze_roughness, amp=amp)
        return out.to(torch.float32 if dt == torch.bfloat16 else dt)

    @functools.cached_property
    def _pack32(self) -> dict:
        """`pack_field_weights` at f32, with a graph to the params if grad is on."""
        with torch.set_grad_enabled(self.grad):
            return pack_field_weights(self.params, self.fcfg)

    @functools.cached_property
    def _k2_pack(self) -> dict:
        """K2's weights: the f32 pack, or without grad `to_bf16` of it."""
        return self._pack32 if self.grad else to_bf16(self._pack32)

    @functools.cached_property
    def _k1_pack(self) -> dict:
        """K1's weights at the no-grad dtype, detached (the embedding f32)."""
        if not self.k2:
            with torch.no_grad():
                return pack_field_weights(self.params, self.fcfg, dtype=self.dt_ng)
        return {k: v.detach() if k.startswith("emb_") else v.detach().to(self.dt_ng)
                for k, v in self._pack32.items()}


def frame_queries(variables, rcfg: RenderConfig) -> tuple[FieldQueries, FieldQueries]:
    """The coarse and the fine pass's queries for `render_rays(queries=)`,
    built under no-grad for every chunk of a frame; one if the field is one."""
    with torch.no_grad():
        coarse = FieldQueries(variables["coarse"], rcfg)
        rcfg_f = _fine_config(rcfg)
        if "fine" not in variables and rcfg_f is rcfg:
            return coarse, coarse
        return coarse, FieldQueries(variables.get("fine", variables["coarse"]), rcfg_f)


def _fine_config(rcfg: RenderConfig) -> RenderConfig:
    """The fine pass's config: `field_fine`, if set, in place of `field`
    (multires and K are shared, so every shape is unchanged)."""
    if rcfg.field_fine is None:
        return rcfg
    return rcfg.replace(field=rcfg.field_fine, field_fine=None)


def _radiance_f(rcfg: RenderConfig):
    return torch.relu if rcfg.use_radiance_linear else torch.sigmoid


# ---------------------------------------------------------------------------
# Sub-renderers
# ---------------------------------------------------------------------------

def _composite_radiance_stack(raw, z_vals, rays_d, rcfg: RenderConfig, heads: str = "all"):
    """radiance + K coarse-radiance maps from a raw field output holding
    the columns of head set `heads`; under "incident" the radiance alone.
    Returns (radiance_map (B,3), [coarse maps (B,3)])."""
    rf = _radiance_f(rcfg)
    weights = weights_from_alpha(
        alpha_from_sigma(raw[..., 0], dists_from_z_vals(z_vals, rays_d)))
    rad = radiance_column(heads)
    radiance_map = accumulate(weights, rf(raw[..., rad:rad + 3]))
    n_coarse = 0 if heads == "incident" else rcfg.field.coarse_radiance_number
    coarse_maps = [accumulate(weights, rf(raw[..., rad + 3 + 3 * k: rad + 6 + 3 * k]))
                   for k in range(n_coarse)]
    return radiance_map, coarse_maps


def _raw_sigma_with_noise(raw_sigma, noise, rcfg: RenderConfig):
    """raw σ plus `raw_noise_std` times the pass's standard normals."""
    if rcfg.raw_noise_std > 0.0:
        return raw_sigma + noise * rcfg.raw_noise_std
    return raw_sigma


def _render_depth_only(query_sigma, rays_o, rays_d, z_vals, rcfg: RenderConfig, noise=None):
    """Depth/visibility-only pass; `noise` as _raw_sigma_with_noise takes it."""
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw = _raw_sigma_with_noise(query_sigma(pts)[..., 0], noise, rcfg)
    alpha = alpha_from_sigma(raw, dists_from_z_vals(z_vals, rays_d))
    weights, visibility = transmittance_and_weights(alpha)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    return {"depth_map": depth_map, "weights": weights,
            "visibility": visibility}


# ---------------------------------------------------------------------------
# Edit / insert masks
# ---------------------------------------------------------------------------

def _decode_object_masks(mask_img: torch.Tensor, num_objects: int):
    """Object masks from gray levels ~10(i+1)/255: object i where
    9(i+1)/255 < m < 11(i+1)/255, and every object where m > 0.
    mask_img: (B,) channel-0 values."""
    masks = [(mask_img > 9.0 * (i + 1) / 255.0) & (mask_img < 11.0 * (i + 1) / 255.0)
             for i in range(num_objects)]
    return masks, mask_img > 0


def _where(mask: torch.Tensor, new, old: torch.Tensor) -> torch.Tensor:
    """Masked override; mask (B,), values (B,) or (B, C). `new` is a
    tensor, a number, or a sequence of C numbers (one per channel);
    constants stay Python numbers, so no host-to-device copy is made."""
    if isinstance(new, (tuple, list)):
        return torch.stack([torch.where(mask, float(v), old[..., c])
                            for c, v in enumerate(new)], dim=-1)
    if old.ndim > mask.ndim:
        mask = mask[..., None]
    return torch.where(mask, new if isinstance(new, torch.Tensor) else float(new), old)


def _gt_normal(g: torch.Tensor) -> torch.Tensor:
    """A normal map stored as (n + 1) / 2, unpacked and normalised."""
    n = 2.0 * g - 1.0
    return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)


def _apply_edit_overrides(edit, masks, mask_all, gt, normal_map, albedo_map,
                          roughness_map, irradiance_map):
    """The intrinsic overrides before shading, in the JAX renderer's
    order: edit (normal, albedo by image or per-object constants,
    roughness likewise) or insert (normal, then per object roughness,
    irradiance where its target is positive, and albedo)."""
    if edit.mode == "edit":
        if edit.edit_normal:
            normal_map = _where(mask_all, _gt_normal(gt["edit_normal"]), normal_map)
        if edit.edit_albedo:
            if edit.edit_albedo_by_img:
                albedo_map = _where(mask_all, gt["edit_albedo"], albedo_map)
            else:
                for i, m in enumerate(masks):
                    albedo_map = _where(m, edit.target_albedo[3 * i: 3 * i + 3], albedo_map)
        if edit.edit_roughness:
            if edit.edit_roughness_by_img:
                roughness_map = _where(mask_all, gt["edit_roughness"][..., 0], roughness_map)
            else:
                for i, r in enumerate(edit.target_roughness):
                    roughness_map = _where(masks[i], r, roughness_map)
    else:  # insert
        normal_map = _where(mask_all, _gt_normal(gt["object_insert_normal"]), normal_map)
        for i, m in enumerate(masks):
            roughness_map = _where(m, edit.target_roughness[i], roughness_map)
            if edit.target_irradiance and edit.target_irradiance[i] > 0:
                irradiance_map = _where(m, edit.target_irradiance[i], irradiance_map)
            albedo_map = _where(m, edit.target_albedo[3 * i: 3 * i + 3], albedo_map)
    return normal_map, albedo_map, roughness_map, irradiance_map


# ---------------------------------------------------------------------------
# The main per-ray renderer
# ---------------------------------------------------------------------------

def _aux_maps(variables, pts, x_surface, weights_det, rcfg: RenderConfig) -> dict:
    """The maps of the aux heads the config turns on, composited on the
    detached weights: "normal", the inferred normal 2 sigmoid - 1 (per
    sample, or at the surface point; not normalised), and the separate
    "albedo", "roughness" and "irradiance"."""
    per_sample = [("normal", rcfg.infer_normal and not rcfg.infer_normal_at_surface,
                   "normal_mlp", slice(None)),
                  ("albedo", rcfg.infer_albedo_separate, "albedo_mlp", slice(0, 3)),
                  ("roughness", rcfg.infer_roughness_separate, "roughness_mlp", 0),
                  ("irradiance", rcfg.infer_irradiance_separate, "irradiance_mlp", 0)]
    out = {}
    if rcfg.infer_normal and rcfg.infer_normal_at_surface:
        pe = positional_encoding(x_surface, rcfg.field.multires)
        out["normal"] = 2.0 * torch.sigmoid(apply_position_mlp(variables["normal_mlp"], pe)) - 1.0
    if any(on for _, on, _, _ in per_sample):
        pe = positional_encoding(pts, rcfg.field.multires)
    for name, on, head, cols in per_sample:
        if on:
            v = torch.sigmoid(apply_position_mlp(variables[head], pe)[..., cols])
            out[name] = accumulate(weights_det, 2.0 * v - 1.0 if name == "normal" else v)
    return out


def _raw2outputs(q: FieldQueries, variables, consts, rays_o, rays_d, z_vals,
                 z_vals_constant, near, far, rcfg: RenderConfig, gt_values=None, noise=None):
    """Full compositing + shading (split-sum or Monte-Carlo) for one
    sample set, the field queried through `q`. gt_values: per-ray gt
    buffers ("normal", "depth", "albedo", "roughness", "irradiance", and
    the edit and insert buffers), read by the modes that substitute them.
    noise: the standard normals added to the primary march's raw σ under
    `raw_noise_std`."""
    rf = _radiance_f(rcfg)
    gt = gt_values or {}
    edit = rcfg.edit

    # --- primary march -----------------------------------------------------
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw = q.full(pts, rays_d)
    sigma_raw = _raw_sigma_with_noise(raw[..., 0], noise, rcfg)
    alpha = alpha_from_sigma(sigma_raw, dists_from_z_vals(z_vals, rays_d))
    weights = weights_from_alpha(alpha)
    weights_det = weights.detach()
    depth_map, disp_map, acc_map = composite_depth_disp_acc(weights, z_vals)

    # --- edit/insert masks and the target depth --------------------------------
    masks, mask_all = [], None
    if edit is not None:
        mask_key = "edit_intrinsic_mask" if edit.mode == "edit" else "object_insert_mask"
        masks, mask_all = _decode_object_masks(gt[mask_key][:, 0], edit.num_objects)
    target_depth_map = gt["depth"][..., 0] if rcfg.depth_map_from_ground_truth else depth_map
    if edit is not None and edit.mode == "edit" and edit.edit_depth:
        target_depth_map = _where(mask_all, gt["edit_depth"][..., 0], target_depth_map)
    if edit is not None and edit.mode == "insert":
        target_depth_map = _where(mask_all, gt["object_insert_depth"][..., 0],
                                  target_depth_map)
    x_surface = (rays_o + rays_d * target_depth_map[..., None]).detach()
    with span("render.aux_heads"):
        aux = _aux_maps(variables, pts, x_surface, weights_det, rcfg)
    inferred_normal_map = aux.get("normal")

    # --- intrinsic maps: detached weights, radiance on live ones; the
    # separate heads replace the field's ----------------------------------
    albedo_map = aux.get("albedo")
    if albedo_map is None:
        albedo_map = accumulate(weights_det, torch.sigmoid(raw[..., 1:4]))
    roughness_map = aux.get("roughness")
    if roughness_map is None:
        roughness_map = accumulate(weights_det, torch.sigmoid(raw[..., 4]))
    irradiance_map = aux.get("irradiance")
    if irradiance_map is None:
        irradiance_map = accumulate(weights_det, rf(raw[..., 5]))
    radiance_map = accumulate(weights, rf(raw[..., 6:9]))
    coarse_radiance_maps = [
        accumulate(weights_det, rf(raw[..., 9 + 3 * k: 12 + 3 * k]))
        for k in range(rcfg.field.coarse_radiance_number)]
    irradiance_map = irradiance_map[..., None]

    # --- gt substitutions ----------------------------------------------------
    target_albedo_map = gt["albedo"] if rcfg.calculate_albedo_from_gt else albedo_map
    target_roughness_map = (gt["roughness"][..., 0] if rcfg.calculate_roughness_from_gt
                            else roughness_map)
    target_irradiance_map = (gt["irradiance"] if rcfg.calculate_irradiance_from_gt
                             else irradiance_map)

    # --- shading --------------------------------------------------------------
    target_normal_map = approximated_radiance_map = None
    specular_map = diffuse_map = n_dot_v = None
    reflected_radiance_map = prefiltered_reflected_map = None
    reflected_coarse_maps = []

    if rcfg.approximate_radiance:
        with span("render.normal"):
            target_normal_map = _estimate_normal(q.sigma, q.sigma_ng, rays_o, rays_d,
                                                 z_vals, pts, x_surface, weights_det,
                                                 inferred_normal_map, gt, rcfg)
        if edit is not None:
            (target_normal_map, target_albedo_map, target_roughness_map,
             target_irradiance_map) = _apply_edit_overrides(
                edit, masks, mask_all, gt, target_normal_map, target_albedo_map,
                target_roughness_map, target_irradiance_map)
        n_dot_v = torch.clamp(torch.sum(-rays_d * target_normal_map, -1), 0.0, 1.0)

    with span("render.shading"):
        if rcfg.approximate_radiance and rcfg.shading_mode == "monte_carlo":
            # no reflected or prefiltered maps in this mode
            diffuse_map, specular_map = _monte_carlo_shading(
                q.full_ng, rays_d, x_surface, z_vals_constant, target_normal_map,
                target_albedo_map, target_roughness_map, rcfg)
            approximated_radiance_map = diffuse_map + specular_map
        elif rcfg.approximate_radiance:
            # split sum: BRDF LUT fetch
            lut_uv = torch.stack(
                [2.0 * n_dot_v - 1.0, 2.0 * target_roughness_map - 1.0], dim=-1)
            env_brdf = grid_sample_2d(consts["brdf_lut"], lut_uv)
            env_c1 = env_brdf[..., 0:1]
            env_c0 = env_brdf[..., 1:2]

            # dielectric F0 with metallic = 1 - roughness
            metallic = (1.0 - target_roughness_map)[..., None]
            f0 = torch.full((3,), 0.04, dtype=raw.dtype, device=raw.device)
            f0 = f0 * (1.0 - metallic) + target_albedo_map * metallic

            fresnel_map = fresnel_schlick_roughness(n_dot_v, f0, target_roughness_map)
            if rcfg.lut_coefficient == "F":
                spec_coeff = fresnel_map * env_c1 + env_c0
            elif rcfg.lut_coefficient == "F0":
                spec_coeff = f0 * env_c1 + env_c0
            else:
                raise ValueError(rcfg.lut_coefficient)

            # reflected-ray second march along the constant coarse z
            reflected_dirs = reflect(rays_d, target_normal_map)
            reflected_pts = (x_surface[..., None, :]
                             + reflected_dirs[..., None, :]
                             * z_vals_constant[..., :, None])
            if rcfg.use_gradient_for_incident_radiance:
                r_raw = q.full(reflected_pts, reflected_dirs)
                reflected_radiance_map, reflected_coarse_maps = _composite_radiance_stack(
                    r_raw, z_vals_constant, reflected_dirs, rcfg)
            else:
                with torch.no_grad():
                    r_raw = q.full_ng(reflected_pts.detach(), reflected_dirs.detach(),
                                      "reflected")
                    reflected_radiance_map, reflected_coarse_maps = _composite_radiance_stack(
                        r_raw, z_vals_constant, reflected_dirs, rcfg, "reflected")
            prefiltered = torch.stack(
                [reflected_radiance_map] + list(reflected_coarse_maps), dim=1)

            # roughness-driven mip level (the field's roughness, as in JAX)
            if rcfg.correct_depth_for_prefiltered_radiance_infer:
                depth_0 = (far + near) * 0.5
                mip_level = torch.clamp(
                    roughness_map * depth_map.detach() / depth_0[..., 0], 0.0, 1.0)
            else:
                mip_level = roughness_map
            prefiltered_reflected_map = mip_interp(prefiltered, mip_level)

            diffuse_map = ((1.0 - fresnel_map) * (1.0 - metallic)
                           * target_albedo_map * target_irradiance_map)
            specular_map = spec_coeff * prefiltered_reflected_map
            approximated_radiance_map = diffuse_map + specular_map

    return _assemble_outputs(
        rcfg, approximated_radiance_map, radiance_map, coarse_radiance_maps,
        reflected_coarse_maps, target_irradiance_map, reflected_radiance_map,
        prefiltered_reflected_map, target_albedo_map, target_roughness_map, specular_map,
        diffuse_map, n_dot_v, target_normal_map, disp_map, acc_map, depth_map,
        weights, target_depth_map, inferred_normal_map)


def _assemble_outputs(rcfg, approximated_radiance_map, radiance_map,
                      coarse_radiance_maps, reflected_coarse_maps,
                      target_irradiance_map, reflected_radiance_map,
                      prefiltered_reflected_map, target_albedo_map,
                      target_roughness_map, specular_map, diffuse_map,
                      n_dot_v, target_normal_map, disp_map, acc_map,
                      depth_map, weights, target_depth_map=None,
                      inferred_normal_map=None):
    """Output transforms + map dict, with the reference's key names;
    target_depth_map defaults to depth_map."""
    ldr = tonemap_reinhard if rcfg.use_radiance_linear else (lambda x: x)
    gam = rgb_to_srgb if rcfg.gamma_correct else (lambda x: x)

    def out_f(x):
        return None if x is None else gam(ldr(x))

    results: dict[str, Any] = {}
    results["color_map"] = out_f(approximated_radiance_map)
    results["radiance_map"] = out_f(radiance_map)
    for k, cm in enumerate(coarse_radiance_maps):
        results[f"radiance_map_{k + 1}"] = out_f(cm)
    for k, cm in enumerate(reflected_coarse_maps):
        results[f"reflected_coarse_radiance_map_{k + 1}"] = out_f(cm)

    results["irradiance_map"] = out_f(target_irradiance_map)
    results["reflected_radiance_map"] = out_f(reflected_radiance_map)
    results["prefiltered_reflected_map"] = out_f(prefiltered_reflected_map)

    results["albedo_map"] = gam(target_albedo_map)
    results["roughness_map"] = target_roughness_map
    results["specular_map"] = out_f(specular_map)
    results["diffuse_map"] = out_f(diffuse_map)
    results["n_dot_v_map"] = n_dot_v

    results["inferred_normal_map"] = inferred_normal_map
    results["target_normal_map"] = target_normal_map
    # the estimator's own key, for losses that name it (the normal_map_*
    # estimators only, as in the JAX renderer)
    if target_normal_map is not None and rcfg.normal_type.startswith("normal_map"):
        results[rcfg.normal_type] = target_normal_map

    results["disp_map"] = disp_map
    results["acc_map"] = acc_map
    results["depth_map"] = depth_map
    results["target_depth_map"] = depth_map if target_depth_map is None else target_depth_map
    results["weights"] = weights
    return {k: v for k, v in results.items() if v is not None}


def _estimate_normal(query_sigma, query_sigma_ng, rays_o, rays_d, z_vals,
                     pts, x_surface, weights_det, inferred_normal_map, gt,
                     rcfg: RenderConfig):
    """The shading normal: the gt normal map (stored as (n + 1) / 2), the
    ε finite differences on the no-grad query, or the depth gradient
    (forward mode) or density gradient of the gradient-path query (bf16
    under bf16_grad, as in the JAX renderer), each carrying no gradient;
    or the inferred normal map as it is, with its gradient to the normal
    head. The gradient-path query stays eager: K2/K3 have no forward
    mode. The ε sweeps add the points they query to
    COUNTERS["eps_normal_points"]."""
    nt = rcfg.normal_type
    if nt == "ground_truth":
        return _gt_normal(gt["normal"])
    if nt == "inferred_normal_map":
        if inferred_normal_map is None:
            raise ValueError("normal_type inferred_normal_map needs infer_normal")
        return inferred_normal_map
    if nt in _AUTOGRAD_NORMALS:
        fn = (normals_mod.normal_from_depth_gradient if nt == "normal_map_from_depth_gradient"
              else normals_mod.normal_from_depth_gradient_direction)
        with torch.no_grad():
            return fn(query_sigma, rays_o.detach(), rays_d.detach(), z_vals.detach()).detach()
    if nt == "normal_map_from_sigma_gradient_surface":
        return normals_mod.normal_from_sigma_gradient_surface(query_sigma, x_surface)
    if nt == "normal_map_from_sigma_gradient":
        return normals_mod.normal_from_sigma_gradient(query_sigma, pts, weights_det)
    sweep = _counted_sweep(query_sigma_ng)
    with torch.no_grad():
        if nt == "normal_map_from_depth_gradient_epsilon":
            return normals_mod.normal_from_depth_gradient_epsilon(
                sweep, rays_o, rays_d, z_vals, rcfg.epsilon, scan=rcfg.sweep_scan)
        if nt == "normal_map_from_depth_gradient_direction_epsilon":
            return normals_mod.normal_from_depth_gradient_direction_epsilon(
                sweep, rays_o, rays_d, z_vals, rcfg.epsilon_direction, scan=rcfg.sweep_scan)
    raise ValueError(nt)


def _counted_sweep(query_sigma):
    """`query_sigma` adding the points of each call, from their shape, to
    COUNTERS["eps_normal_points"]."""
    def query(pts):
        COUNTERS["eps_normal_points"] += pts.numel() // 3
        return query_sigma(pts)
    return query


@functools.cache
def _hemisphere(n: int, device: torch.device) -> torch.Tensor:
    """`hemisphere_samples(n)` on the device, copied there once."""
    return torch.from_numpy(hemisphere_samples(n)).to(device)


def _monte_carlo_shading(query_full_ng, rays_d, x_surface, z_vals_constant,
                         normal_map, albedo_map, roughness_map, rcfg: RenderConfig):
    """GGX microfacet Monte-Carlo shading: M = mc_samples_axis² fixed
    low-discrepancy hemisphere directions about the shading normal, each
    marched through the no-grad field, `query_full_ng(pts, dirs,
    "incident")` (K1 full on σ and the radiance under use_pallas: B·M
    rays of the constant coarse z), for its incident radiance, weighted by
    the GGX glossy and Lambert diffuse BRDF and the uniform-hemisphere
    weight 2π/M. The incident radiance and the directions carry no
    gradient; the BRDF terms carry it to the normal, albedo and roughness
    maps, as in the JAX renderer. With spans on, the marches are the span
    `render.mc_incident` and the BRDF sums `render.mc_brdf`; each march
    adds its B·M·S points to COUNTERS["mc_incident_points"]. Returns
    (diffuse (B, 3), specular (B, 3))."""
    b, s = rays_d.shape[0], z_vals_constant.shape[-1]
    local = _hemisphere(rcfg.mc_samples_axis, rays_d.device)   # (M, 3)
    m = local.shape[0]

    with span("render.mc_incident"):
        wdirs = _world_directions(local, normal_map)
        with torch.no_grad():
            z = z_vals_constant[:, None, :].expand(b, m, s).reshape(b * m, s)
            flat_dirs = wdirs.reshape(b * m, 3)
            pts = (x_surface[:, None, None, :] + wdirs[:, :, None, :]
                   * z.reshape(b, m, s)[..., None]).reshape(b * m, s, 3)
            raw = query_full_ng(pts, flat_dirs, "incident")
            COUNTERS["mc_incident_points"] += b * m * s
            incident, _ = _composite_radiance_stack(raw, z, flat_dirs, rcfg, "incident")
            incident = incident.reshape(b, m, 3)

    with span("render.mc_brdf"):
        brdf_glossy, brdf_diffuse, l_dot_n = microfacet_brdf(
            wdirs, -rays_d, normal_map, albedo_map, roughness_map[..., None])
        w_mc = 2.0 * torch.pi / m   # the uniform hemisphere's pdf is 1/2π
        specular = w_mc * torch.sum(brdf_glossy * incident * l_dot_n, dim=1)
        diffuse = w_mc * torch.sum(brdf_diffuse * incident * l_dot_n, dim=1)
    return diffuse, specular


def _world_directions(local: torch.Tensor, normal_map: torch.Tensor) -> torch.Tensor:
    """The hemisphere directions (M, 3) about +z turned about each normal
    (B, 3): unit world-space directions (B, M, 3) in the frame (tangent,
    binormal, normal) of `get_tbn`, without a gradient."""
    binormal, tangent = get_tbn(normal_map)
    wdirs = (local[None, :, 0, None] * tangent[:, None, :]
             + local[None, :, 1, None] * binormal[:, None, :]
             + local[None, :, 2, None] * normal_map[:, None, :])
    return (wdirs / torch.clamp(torch.linalg.vector_norm(wdirs, dim=-1, keepdim=True),
                                min=1e-12)).detach()


# ---------------------------------------------------------------------------
# render_rays: coarse -> importance resample -> fine
# ---------------------------------------------------------------------------

def make_ray_batch(rays_o, rays_d, near, far):
    """Pack a ray batch dict; near/far scalars or (B,) tensors."""
    b = rays_o.shape[0]

    def per_ray(v):
        if not isinstance(v, torch.Tensor):  # filled on the device, no host copy
            return torch.full((b, 1), float(v), dtype=rays_o.dtype, device=rays_o.device)
        return v.to(rays_o.dtype).expand(b)[..., None]

    viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    return {"rays_o": rays_o, "rays_d": rays_d, "viewdirs": viewdirs,
            "near": per_ray(near), "far": per_ray(far)}


def render_draws_needed(rcfg: RenderConfig) -> bool:
    """Whether render_rays under `rcfg` takes random draws."""
    return rcfg.perturb or rcfg.raw_noise_std > 0.0


def draw_render_uniforms(n_rays: int, rcfg: RenderConfig, device,
                         generator: torch.Generator | None = None,
                         dtype: torch.dtype = torch.float32) -> dict:
    """The draws of one render_rays call. Under perturb, uniforms:
    "strat" (B, n_samples) jitters the stratified z, "pdf" (B,
    n_importance) drives sample_pdf (JAX's k_strat and k_pdf, in the
    dtype of the rays). Under raw_noise_std, also with perturb off,
    standard normals for raw σ: "noise_coarse" (B, n_samples) and, with
    a fine pass, "noise_fine" (B, n_samples + n_importance) (JAX's
    k_coarse and k_fine, split once more in a shading pass)."""
    out = {}
    if rcfg.perturb:
        for name, n in (("strat", rcfg.n_samples), ("pdf", rcfg.n_importance)):
            out[name] = torch.rand((n_rays, n), device=device, generator=generator, dtype=dtype)
    if rcfg.raw_noise_std > 0.0:
        shapes = [("noise_coarse", rcfg.n_samples)]
        if rcfg.n_importance > 0:
            shapes.append(("noise_fine", rcfg.n_samples + rcfg.n_importance))
        for name, n in shapes:
            out[name] = torch.randn((n_rays, n), device=device, generator=generator, dtype=dtype)
    return out


def render_rays(variables, consts, batch, rcfg: RenderConfig,
                is_depth_only: bool = False, draws: dict | None = None,
                generator: torch.Generator | None = None, gt_values: dict | None = None,
                queries: tuple[FieldQueries, FieldQueries] | None = None):
    """Render a ray batch into all output maps.

    variables: {'coarse': field params, 'fine': field params | absent,
               and the aux heads the config turns on: 'normal_mlp',
               'depth_mlp', '{albedo,roughness,irradiance}_mlp'}
    consts:    {'brdf_lut': (H, W, C)} non-trainable assets.
    batch:     make_ray_batch output.
    draws:     under perturb or raw_noise_std, `draw_render_uniforms`'s
               draws; drawn from `generator` on the rays' device when absent.
    gt_values: per-ray gt buffers, (B, C) each (the train step passes its
               pixel batch), for the gt normal and the gt substitutions.
    queries:   the (coarse, fine) `FieldQueries` of `frame_queries`, shared
               by the calls of one frame under no-grad; when absent each
               pass builds its own.
    Returns a dict of maps; coarse-pass results are suffixed '0' when a
    fine pass runs. Differentiable with respect to the params; wrap it in
    torch.no_grad() to render without a graph.
    """
    _check_supported(rcfg)
    pin_f32_matmul()
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    near, far = batch["near"], batch["far"]
    if render_draws_needed(rcfg) and draws is None:
        draws = draw_render_uniforms(rays_o.shape[0], rcfg, rays_o.device, generator,
                                     dtype=rays_o.dtype)
    draws = draws or {}

    z_vals = stratified_z_vals(near, far, rcfg.n_samples, lindisp=rcfg.lindisp,
                               perturb=rcfg.perturb,
                               u=draws["strat"] if rcfg.perturb else None)
    z_vals_constant = z_vals

    with span("render.coarse"):
        q = queries[0] if queries else FieldQueries(variables["coarse"], rcfg)
        if is_depth_only or (not rcfg.coarse_shading and rcfg.n_importance > 0):
            # Inference fast path: the coarse pass only has to produce the
            # importance-resampling weights (+ depth); the gradient-path
            # density query shares trunk+sigma with the full one, so every
            # fine buffer is unchanged.
            result = _render_depth_only(q.sigma, rays_o, rays_d, z_vals, rcfg,
                                        draws.get("noise_coarse"))
        else:
            result = _raw2outputs(q, variables, consts, rays_o, rays_d, z_vals,
                                  z_vals_constant, near, far, rcfg, gt_values,
                                  draws.get("noise_coarse"))

    if rcfg.n_importance > 0:
        with span("render.importance"):
            z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            with torch.no_grad():
                z_samples = sample_pdf(z_mid, result["weights"][..., 1:-1],
                                       rcfg.n_importance, det=not rcfg.perturb,
                                       u=draws["pdf"] if rcfg.perturb else None)
            z_all, _ = torch.sort(torch.cat([z_vals, z_samples], -1), dim=-1)

        rcfg_f = _fine_config(rcfg)
        with span("render.fine"):
            q = queries[1] if queries else FieldQueries(
                variables.get("fine", variables["coarse"]), rcfg_f)
            if is_depth_only:
                result_fine = _render_depth_only(q.sigma, rays_o, rays_d, z_all, rcfg_f,
                                                 draws.get("noise_fine"))
            else:
                result_fine = _raw2outputs(q, variables, consts, rays_o, rays_d,
                                           z_all, z_vals_constant, near, far,
                                           rcfg_f, gt_values, draws.get("noise_fine"))
        for k, v in result.items():
            result_fine[k + "0"] = v
        result = result_fine
        result["z_std"] = torch.std(z_samples, dim=-1, correction=0)

    if rcfg.infer_depth:
        with span("render.depth_head"):
            pe = positional_encoding(rays_o[..., None, :], rcfg.field.multires)
            de = positional_encoding(batch["viewdirs"][..., None, :],
                                     rcfg.field.multires_views)
            out = apply_position_direction_mlp(variables["depth_mlp"], pe, de)
            result["inferred_depth_map"] = torch.relu(out[..., 0]).squeeze(-1)
    return result


# ---------------------------------------------------------------------------
# Whole-frame rendering (inference fast path)
# ---------------------------------------------------------------------------

def make_frame_render_fn(variables, consts, rcfg: RenderConfig,
                         output_keys: tuple[str, ...] | None = None,
                         staticcam: bool = False, render_fn=None):
    """A function that renders a frame pre-tiled as (n_chunks, chunk, 3)
    ray tensors, one chunk after another, keeping only `output_keys`.

    Returns fn(rays_o_t, rays_d_t, near, far, gt_t=None, viewdirs_t=None)
    -> {name: (n_chunks, chunk, C?)}; gt_t is a dict of (n_chunks, chunk,
    C) gt buffers, tiled as the rays are. viewdirs_t is consulted only
    when staticcam=True: the batch's viewdirs come from it (the rays of
    another camera), as JAX's render_decomp takes c2w_staticcam. Each
    call prepares the field queries once (`frame_queries`) for all its
    chunks. `render_fn(batch, gt)` renders a chunk in place of
    render_rays (e.g. parallel.mesh.make_sharded_render_fn).
    """
    _check_supported(rcfg)

    @torch.no_grad()
    def run(rays_o_t, rays_d_t, near, far, gt_t=None, viewdirs_t=None):
        render = render_fn
        if render is None:
            queries = frame_queries(variables, rcfg)

            def render(batch, gt):
                return render_rays(variables, consts, batch, rcfg, gt_values=gt, queries=queries)
        outs = []
        for i, (ro, rd) in enumerate(zip(rays_o_t, rays_d_t)):
            gt = {k: v[i] for k, v in gt_t.items()} if gt_t else None
            batch = make_ray_batch(ro, rd, near, far)
            if staticcam:   # the viewdirs of another camera's rays
                vd = viewdirs_t[i]
                batch["viewdirs"] = vd / torch.linalg.vector_norm(vd, dim=-1, keepdim=True)
            out = render(batch, gt)
            if output_keys is not None:
                out = {k: out[k] for k in output_keys if k in out}
            outs.append(out)
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return run


def _pad_tile(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Pad (N, ...) to a chunk multiple by repeating the last row, then
    tile to (n_chunks, chunk, ...)."""
    pad = (-x.shape[0]) % chunk
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
    return x.reshape(-1, chunk, *x.shape[1:])


def render_frame(fn, rays_o, rays_d, near, far, chunk: int, gt_values: dict | None = None,
                 viewdirs: torch.Tensor | None = None):
    """Drive a make_frame_render_fn function over flat (N, 3) rays, (N, C)
    gt buffers and (N, 3) viewdirs (rays_d when absent): pad to a chunk
    multiple, tile, run, un-tile. Returns {name: (N, C?)}."""
    n = rays_o.shape[0]
    gt_t = {k: _pad_tile(v, chunk) for k, v in (gt_values or {}).items()}
    vd_t = _pad_tile(rays_d if viewdirs is None else viewdirs, chunk)
    out = fn(_pad_tile(rays_o, chunk), _pad_tile(rays_d, chunk), near, far, gt_t, vd_t)
    return {k: v.reshape(-1, *v.shape[2:])[:n] for k, v in out.items()}


def render_image(variables, consts, H, W, K, c2w, near, far,
                 rcfg: RenderConfig, gt_values: dict | None = None, chunk: int = 2048,
                 c2w_staticcam: torch.Tensor | None = None, render_fn=None):
    """Render a full image chunk by chunk through make_frame_render_fn and
    render_frame; gt_values entries are flat (H*W, C). Every per-ray map
    comes back as (H, W, C?). With c2w_staticcam the rays come from that
    camera while the viewdirs keep c2w's, which shows the view
    dependence. `render_fn(batch, gt)` renders a chunk in place of
    render_rays (e.g. parallel.mesh.make_sharded_render_fn)."""
    rays_o, rays_d = get_rays_full_image(H, W, K, c2w)
    viewdirs = rays_d.reshape(-1, 3)
    if c2w_staticcam is not None:
        rays_o, rays_d = get_rays_full_image(H, W, K, c2w_staticcam)
    fn = make_frame_render_fn(variables, consts, rcfg, staticcam=c2w_staticcam is not None,
                              render_fn=render_fn)
    out = render_frame(fn, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), near, far, chunk,
                       gt_values=gt_values, viewdirs=viewdirs)
    return {k: v.reshape(H, W, *v.shape[1:]) for k, v in out.items()}
