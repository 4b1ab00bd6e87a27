"""Loss assembly with the reference's staged warm-up schedule.

Counterpart of ibl_nerf_tpu/train/losses.py. Each loss adds the
coarse-pass ('0'-suffixed) term when present. The stage gates are
static per phase (`resolve_phase`). As in the JAX package, the prior
irradiance loss compares shape-matched values (the reference broadcasts
(B, 1) against (B,) to (B, B)).
"""

from __future__ import annotations

import dataclasses

import torch


def _mse(a, b):
    return torch.mean((a - b) ** 2)


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-10)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    beta_render: float = 1.0
    beta_radiance_render: float = 1.0
    beta_albedo_render: float = 1.0        # logged only (the reference drops it from the total)
    beta_inferred_normal: float = 0.1
    beta_inferred_depth: float = 1.0
    beta_sigma_depth: float = 1.0
    beta_roughness_render: float = 1.0
    beta_prior_albedo: float = 0.01
    beta_prior_irradiance: float = 0.0
    beta_irradiance_reg: float = 0.0

    n_iter_ignore_normal: int = 15000
    n_iter_ignore_depth: int = 15000
    n_iter_ignore_approximated_radiance: int = 5000
    n_iter_ignore_prior: int = 10000

    coarse_radiance_number: int = 3
    load_priors: bool = False
    albedo_prior_type: str = "rgb"  # "rgb" | "chrom"
    learn_albedo_from_oracle: bool = False

    initialize_roughness: bool = False
    roughness_init: float = 0.5

    infer_normal: bool = False
    infer_normal_target: str = "normal_map_from_depth_gradient_epsilon"
    infer_depth: bool = False
    depth_map_from_ground_truth: bool = False
    train_depth_from_ground_truth: bool = False

    freeze_radiance: bool = False
    freeze_roughness: bool = False


@dataclasses.dataclass(frozen=True)
class Phase:
    """Static activation of loss terms and model freezing for a step."""

    approximate_radiance: bool
    normal_loss_on: bool
    depth_loss_on: bool
    prior_loss_on: bool
    roughness_init_on: bool
    freeze_radiance: bool
    freeze_roughness: bool


def resolve_phase(step: int, cfg: LossConfig) -> Phase:
    approx = step >= cfg.n_iter_ignore_approximated_radiance
    prior_on = cfg.load_priors and step >= cfg.n_iter_ignore_prior
    freeze_rough = prior_on and cfg.freeze_roughness
    # freeze_roughness also freezes radiance; the standalone
    # freeze_radiance flag gates at the approximate-radiance threshold.
    freeze_rad = (approx and cfg.freeze_radiance) or freeze_rough
    return Phase(
        approximate_radiance=approx,
        normal_loss_on=cfg.infer_normal and step >= cfg.n_iter_ignore_normal,
        depth_loss_on=cfg.infer_depth and step >= cfg.n_iter_ignore_depth,
        prior_loss_on=prior_on,
        roughness_init_on=(cfg.initialize_roughness
                           and step < cfg.n_iter_ignore_approximated_radiance),
        freeze_radiance=freeze_rad,
        freeze_roughness=freeze_rough,
    )


def _with_coarse(result, key, fn):
    """fn over key, plus the same over key+'0' when present."""
    total = fn(result[key]) if key in result else 0.0
    if key + "0" in result:
        total = total + fn(result[key + "0"])
    return total


def _pair_loss(result, key, target):
    return _with_coarse(result, key, lambda x: _mse(x, target))


def _scalar_loss(result, key, value):
    return _with_coarse(result, key, lambda x: _mse(x, torch.full_like(x, value)))


def _key_loss(result, key, target_key, fallback_key=None):
    """Loss against another result key; the coarse target falls back to
    the fine one when no '0' variant exists, and `fallback_key` stands in
    for an absent target. 0.0 when neither exists."""
    if target_key not in result and fallback_key in result:
        target_key = fallback_key
    if key not in result or target_key not in result:
        return 0.0
    total = _mse(result[key], result[target_key])
    if key + "0" in result:
        total = total + _mse(result[key + "0"],
                             result.get(target_key + "0", result[target_key]))
    return total


def compute_losses(result: dict, pixel_info: dict, cfg: LossConfig,
                   phase: Phase, prior_irradiance_mean: float,
                   far: float, depth_volume_result: dict | None = None,
                   depth_volume_weight: float = 1.0):
    """Returns (total_loss, scalars dict). `result` is the render output,
    `pixel_info` the sampled gt pixel dict. `depth_volume_weight` scales
    the depth-volume term: a shard of a data-parallel batch weighs its
    share of the volume rays against its share of the batch."""
    scalars = {}
    target_rgb = pixel_info["rgb"]
    target_chrom = (pixel_info["albedo"] if cfg.learn_albedo_from_oracle
                    else _unit(target_rgb))

    loss_render = _pair_loss(result, "color_map", target_rgb)
    loss_radiance = _pair_loss(result, "radiance_map", target_rgb)
    loss_coarse = [_pair_loss(result, f"radiance_map_{k + 1}", pixel_info[f"rgb_{k + 1}"])
                   for k in range(cfg.coarse_radiance_number)]
    # albedo chromaticity: logged only
    loss_albedo_render = _pair_loss(result, "albedo_map", target_chrom)

    total = cfg.beta_radiance_render * loss_radiance
    for lc in loss_coarse:
        total = total + cfg.beta_radiance_render * lc

    loss_sigma_depth = 0.0
    if cfg.depth_map_from_ground_truth and cfg.train_depth_from_ground_truth:
        loss_sigma_depth = _pair_loss(result, "depth_map", pixel_info["depth"][..., 0])
        loss_sigma_depth = loss_sigma_depth / (far * far * 0.1)
        total = total + cfg.beta_sigma_depth * loss_sigma_depth

    if phase.roughness_init_on:
        loss_rough_init = _scalar_loss(result, "roughness_map", cfg.roughness_init)
        total = total + cfg.beta_roughness_render * loss_rough_init
        scalars["loss_roughness_init"] = loss_rough_init

    loss_inferred_normal = 0.0
    if phase.normal_loss_on:
        tgt = cfg.infer_normal_target
        if tgt == "ground_truth":
            tgt = "ground_truth_normal"
        if tgt == "ground_truth_normal" and "normal" in pixel_info:
            result = {**result, "ground_truth_normal": _unit(pixel_info["normal"] * 2.0 - 1.0)}
        loss_inferred_normal = _key_loss(result, "inferred_normal_map", tgt,
                                         fallback_key="target_normal_map")
        total = total + cfg.beta_inferred_normal * loss_inferred_normal

    if phase.approximate_radiance:
        total = total + cfg.beta_render * loss_render

    loss_depth = 0.0
    if phase.depth_loss_on and "inferred_depth_map" in result:
        loss_depth = _mse(result["inferred_depth_map"], result["depth_map"].detach())
        if depth_volume_result is not None:
            loss_depth = loss_depth + depth_volume_weight * _mse(
                depth_volume_result["inferred_depth_map"], depth_volume_result["depth_map"])
        total = total + cfg.beta_inferred_depth * loss_depth

    loss_prior_albedo = loss_prior_irr = loss_irr_reg = 0.0
    if phase.prior_loss_on:
        if cfg.albedo_prior_type == "chrom":
            # fine pass only, as the reference
            loss_prior_albedo = _mse(_unit(result["albedo_map"]),
                                     _unit(pixel_info["prior_albedo"]))
        else:
            loss_prior_albedo = _pair_loss(result, "albedo_map", pixel_info["prior_albedo"])
        loss_prior_irr = _pair_loss(result, "irradiance_map",
                                    pixel_info["prior_irradiance"][..., None])
        loss_irr_reg = _mse(result["irradiance_map"],
                            torch.full_like(result["irradiance_map"], prior_irradiance_mean))
        total = (total + cfg.beta_prior_albedo * loss_prior_albedo
                 + cfg.beta_prior_irradiance * loss_prior_irr
                 + cfg.beta_irradiance_reg * loss_irr_reg)

    # collapse-detector signal: mean fine accumulated opacity
    if "acc_map" in result:
        scalars["acc_mean"] = torch.mean(result["acc_map"])

    scalars.update({
        "loss_total": total,
        "loss_render": loss_render,
        "loss_radiance": loss_radiance,
        "loss_albedo_render": loss_albedo_render,
        "loss_inferred_normal": loss_inferred_normal,
        "loss_depth": loss_depth,
        "loss_sigma_depth": loss_sigma_depth,
        "loss_prior_albedo": loss_prior_albedo,
        "loss_prior_irradiance": loss_prior_irr,
        "loss_irradiance_reg": loss_irr_reg,
    })
    for k, lc in enumerate(loss_coarse):
        scalars[f"loss_radiance_coarse_{k + 1}"] = lc
    return total, scalars
