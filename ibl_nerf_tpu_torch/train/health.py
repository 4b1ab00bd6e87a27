"""Training health: dead-init rejection and collapse detection.

Counterpart of ibl_nerf_tpu/train/health.py. With the reference's
architecture (ReLU density on a Linear head initialised
U(+-1/sqrt(fan_in))) about 30% of field initialisations start with raw
sigma below 0 at every point of the scene volume, and such a field never
learns geometry: its density and the gradient through it stay 0 while
the loss settles into a plausible band.

- `reject_dead_inits` probes raw sigma along training-view rays at init
  and re-draws a dead or near-dead field, deterministically from the
  seed; a healthy draw is returned unchanged.
- `check_collapse` warns when the acc coverage of a train batch or of a
  held-out render has cratered.
"""

from __future__ import annotations

import numpy as np
import torch

from ibl_nerf_tpu_torch.models.field import FieldConfig, apply_field_density, init_field_params
from ibl_nerf_tpu_torch.ops.embedding import positional_encoding
from ibl_nerf_tpu_torch.ops.rays import get_rays_full_image

# acc below this, averaged over a train batch or a held-out render, is
# "the field sees (almost) nothing" -- a live scene batch sits near 1.0.
ACC_COLLAPSE_THRESHOLD = 0.05


def probe_points_from_scene(scene, n_rays: int = 256, n_samples: int = 32) -> np.ndarray:
    """Points along training-view rays between near and far -- the region
    the renderer queries during training."""
    K = torch.from_numpy(scene.focal_matrix())
    per_pose = max(1, n_rays // len(scene.poses))
    t = np.linspace(float(scene.near), float(scene.far), n_samples, dtype=np.float32)
    rng = np.random.default_rng(0)
    pts = []
    for pose in np.asarray(scene.poses, np.float32):
        o, d = get_rays_full_image(scene.height, scene.width, K,
                                   torch.from_numpy(np.ascontiguousarray(pose[:3, :4])))
        o, d = o.reshape(-1, 3).numpy(), d.reshape(-1, 3).numpy()
        sel = rng.integers(0, o.shape[0], per_pose)
        pts.append(o[sel, None, :] + d[sel, None, :] * t[None, :, None])
    return np.concatenate(pts).reshape(-1, 3).astype(np.float32)


@torch.no_grad()
def field_density_stats(params, fcfg: FieldConfig, probe_pts: np.ndarray):
    """(fraction of probe points with raw sigma > 0, max raw sigma)."""
    device = params["sigma"]["w"].device
    pe = positional_encoding(torch.as_tensor(probe_pts, device=device), fcfg.multires)
    raw = apply_field_density(params, pe, fcfg)[..., 0]
    return float((raw > 0.0).float().mean()), float(raw.max())


def reject_dead_inits(seed: int, variables: dict, fcfg: FieldConfig, probe_pts: np.ndarray,
                      fcfg_fine: FieldConfig | None = None, max_retries: int = 16,
                      min_fracpos: float = 0.01, logger=None) -> dict:
    """Re-draw any density field whose initialisation is dead (max raw
    sigma <= 0 over the probe points) or near-dead (fewer than
    `min_fracpos` of them positive), "coarse" first, then "fine". Each
    re-draw comes from a generator seeded with (seed, field, retry), so
    results are deterministic per seed. `min_fracpos=0` keeps only the
    dead gate."""
    out = dict(variables)
    for name in ("coarse", "fine"):
        if name not in out:
            continue
        cfg = fcfg_fine if (name == "fine" and fcfg_fine is not None) else fcfg
        device = out[name]["sigma"]["w"].device
        fp, mx = field_density_stats(out[name], cfg, probe_pts)
        retry = 0
        while (mx <= 0.0 or fp < min_fracpos) and retry < max_retries:
            retry += 1
            rng = np.random.default_rng((seed, 0x5EED, ord(name[0]), retry))
            out[name] = init_field_params(rng, cfg, device)
            fp, mx = field_density_stats(out[name], cfg, probe_pts)
        if retry and logger is not None:
            logger.warning(
                "init rejection: %s field density was dead or near-dead at init "
                "(over %d scene probe points) -- re-drew %d time(s); now "
                "fracpos=%.3f max=%.3f", name, len(probe_pts), retry, fp, mx)
        if (mx <= 0.0 or fp < min_fracpos) and logger is not None:
            logger.error("init rejection: %s field STILL dead/near-dead after %d "
                         "retries -- training quality will suffer for this field",
                         name, max_retries)
    return out


def testset_acc_coverage(results: dict) -> float | None:
    """Mean held-out acc coverage from a render_path result stack."""
    if "acc" not in results:
        return None
    return float(np.mean(np.asarray(results["acc"])))


def check_collapse(acc_mean: float, step: int, logger=None,
                   source: str = "train-batch") -> bool:
    """True (and warns loudly) when acc coverage has cratered."""
    if acc_mean is None or acc_mean >= ACC_COLLAPSE_THRESHOLD:
        return False
    if logger is not None:
        logger.error(
            "COLLAPSE DETECTED at step %d: %s acc coverage %.4f < %.2f while loss "
            "may still look plausible -- the density field is (nearly) empty. If "
            "this is early training, the init was likely dead (run with init "
            "rejection enabled, the default); a mid-training crater indicates "
            "optimization collapse.", step, source, acc_mean, ACC_COLLAPSE_THRESHOLD)
    return True
