"""Faults planted under the timed path, for the tests and readings that
show the comparison fails them. Each `install_*` patches the port in this
process and returns the function that undoes it."""

from __future__ import annotations

import torch


def _patch(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, old)


def install_state_unchanged():
    """The optimizer step returns the state unchanged."""
    from ibl_nerf_tpu_torch.train import step

    return _patch(step.NamedAdam, "update_", lambda self, variables, grads, opt_state: None)


def install_half_batch():
    """The loss takes the first half of the batch's rays, their mean over
    that half."""
    from ibl_nerf_tpu_torch.train import step

    old = step.TrainStep.batch_loss

    def batch_loss(self, variables, consts, batch, draws, n_vol=None, vol_weight=1.0):
        pixel_info, rays_o, rays_d = batch[:3]
        half = rays_o.shape[0] // 2
        pixel_info = {k: v[:half] for k, v in pixel_info.items()}
        draws = dict(draws, render={k: v[:half] for k, v in draws["render"].items()})
        return old(self, variables, consts, (pixel_info, rays_o[:half], rays_d[:half]),
                   draws, n_vol, vol_weight)

    return _patch(step.TrainStep, "batch_loss", batch_loss)


def install_answer_altered():
    """Every rendered colour is off by 0.01 where it is produced."""
    from ibl_nerf_tpu_torch.render import renderer

    old = renderer.render_rays

    def render_rays(*args, **kwargs):
        out = old(*args, **kwargs)
        if "color_map" in out:
            out["color_map"] = out["color_map"] + 0.01
        return out

    return _patch(renderer, "render_rays", render_rays)


def install_half_rays():
    """Each chunk renders its first half of the rays; the second half's
    answers repeat them."""
    from ibl_nerf_tpu_torch.render import renderer

    old = renderer.render_rays

    def render_rays(variables, consts, batch, rcfg, **kwargs):
        b = batch["rays_o"].shape[0]
        half = {k: v[:b // 2] for k, v in batch.items()}
        gt = kwargs.get("gt_values")
        if gt:
            kwargs["gt_values"] = {k: v[:b // 2] for k, v in gt.items()}
        out = old(variables, consts, half, rcfg, **kwargs)
        return {k: torch.cat([v, v[:b - b // 2]]) if torch.is_tensor(v) and v.ndim and
                v.shape[0] == b // 2 else v for k, v in out.items()}

    return _patch(renderer, "render_rays", render_rays)


TRAIN = {"state_unchanged": install_state_unchanged, "half_batch": install_half_batch}
RENDER = {"answer_altered": install_answer_altered, "half_rays": install_half_rays}
