"""The train step: pixel sampling -> render -> loss -> Adam.

Counterpart of ibl_nerf_tpu/train/step.py for one device: named Adam
param groups with per-group exponential learning-rate decay and start
offsets, the optimizer written out by hand so that it gives optax's
`scale_by_adam` + `scale_by_schedule` + `scale(-1)` update (eps outside
the square root, bias correction from count 1). The moments and the
params are updated in place: the step owns its `TrainState`, as the
jitted JAX step owns the buffers it donates.

Random draws (image and pixel indices, stratified jitter, importance
uniforms, the depth-volume pass's directions and its own render draws)
come from a `torch.Generator` on the data's device, or are passed in as
a dict (`TrainStep.draw`) so that two steps can share them. Sampling is
single-image or merged (an image per ray); the pixel batch doubles as
the renderer's gt inputs. Once the depth loss is on (`infer_depth`) and
the batch carries gt normals, the depth-volume pass renders random rays
from the surface points for the depth distillation loss. Under `patch`
sampling the 8 neighbours of every pixel render depth-only without a
graph, with draws of their own, for the logged
`patch_depth_smoothness` (the mean over pixels of their depths'
population std); the loss and its gradients are those of the pixel
step. `make_optimizer_step` turns a loss into the in-place Adam step
that this step and the data-parallel steps of `parallel/` share. With
spans on (`utils/timing`) an update is the span `train.update` (its unit
the state's step) over `train.forward`, `train.backward` and
`train.optimizer`; the depth-volume pass is `train.depth_volume`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ibl_nerf_tpu_torch.data.sampler import draw_pixels, sample_pixel_batch
from ibl_nerf_tpu_torch.render.config import RenderConfig
from ibl_nerf_tpu_torch.render.renderer import (
    draw_render_uniforms,
    make_ray_batch,
    render_draws_needed,
    render_rays,
)
from ibl_nerf_tpu_torch.train.losses import LossConfig, Phase, compute_losses
from ibl_nerf_tpu_torch.utils.timing import span


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


@dataclasses.dataclass
class TrainState:
    variables: Any      # {group: param tree}, leaves requiring grad
    opt_state: dict     # {group: GroupState}
    step: int           # global step


@dataclasses.dataclass
class GroupState:
    mu: list[torch.Tensor]   # first moments, one per leaf of the group
    nu: list[torch.Tensor]   # second moments
    count: int = 0           # updates of the Adam chain so far
    seen: int = 0            # updates offered to a delayed group so far


# Per-group LR decay start offsets; decay factor 0.1 over lrate_decay*1000
# steps from each group's start count.
GROUP_START_KEYS = {
    "coarse": 0,
    "fine": 0,
    "depth_mlp": "n_iter_ignore_depth",
    "normal_mlp": "n_iter_ignore_normal",
    "albedo_mlp": "n_iter_ignore_approximated_radiance",
    "roughness_mlp": "n_iter_ignore_approximated_radiance",
    "irradiance_mlp": "n_iter_ignore_approximated_radiance",
    "visibility_mlp": 0,
}


def _group_schedule(lrate: float, decay_steps: float, start: int):
    """Update #c (0-based) runs at lrate*0.1^(max(c-1-start, 0)/decay_steps),
    in f32: the reference sets the LR after its optimizer step, so step i
    uses the LR of global step i-1, decayed only past the group's start."""
    def sched(count: int) -> np.float32:
        exponent = np.float32(max(max(count, 0) - 1 - start, 0)) / np.float32(decay_steps)
        return np.float32(lrate) * np.power(np.float32(0.1), exponent)
    return sched


@dataclasses.dataclass(frozen=True)
class GroupOptimizer:
    """Adam(0.9, 0.999, eps 1e-8) at the group's schedule.

    delay > 0 is `_delayed_start`: the group's first `delay` updates are
    zero and leave its state untouched, as torch skips params whose grad
    is None until their loss first runs; from then on its Adam count and
    schedule start at 0."""

    lrate: float
    decay_steps: float
    start: int
    delay: int = 0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def update_(self, params: list, grads: list, st: GroupState) -> None:
        """One update of the group, in place on params and moments."""
        if self.delay > 0:
            st.seen += 1
            if st.seen - 1 < self.delay:
                return
        lr = float(_group_schedule(self.lrate, self.decay_steps, self.start)(st.count))
        c = st.count + 1
        # bias corrections in f32 on the host, as optax computes them
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(c))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(c))
        # optax: mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu;
        # u = (mu/bc1) / (sqrt(nu/bc2) + eps); p += -(lr u). The same
        # elementwise ops over all of the group's tensors at once.
        g1 = torch._foreach_mul(grads, 1.0 - self.b1)
        torch._foreach_mul_(st.mu, self.b1)
        torch._foreach_add_(st.mu, g1)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_mul_(st.nu, self.b2)
        torch._foreach_add_(st.nu, g2)
        den = torch._foreach_div(st.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(st.mu, bc1)
        torch._foreach_div_(u, den)
        torch._foreach_mul_(u, lr)
        torch._foreach_sub_(params, u)
        st.count = c


@dataclasses.dataclass(frozen=True)
class NamedAdam:
    groups: dict[str, GroupOptimizer]

    def init(self, variables: dict) -> dict[str, GroupState]:
        return {name: GroupState(mu=[torch.zeros_like(p) for p in _leaves(variables[name])],
                                 nu=[torch.zeros_like(p) for p in _leaves(variables[name])])
                for name in self.groups}

    @torch.no_grad()
    def update_(self, variables: dict, grads: dict, opt_state: dict) -> None:
        for name, opt in self.groups.items():
            opt.update_(_leaves(variables[name]), _leaves(grads[name]), opt_state[name])


def build_optimizer(variables: dict, lrate: float = 5e-4,
                    lrate_decay: int = 250, lcfg: LossConfig | None = None,
                    group_lr_overrides: dict[str, float] | None = None,
                    normal_feeds_shading: bool = False) -> NamedAdam:
    """Named-group Adam with per-group exponential schedules.

    group_lr_overrides: per-group base LR. normal_feeds_shading: the
    renderer shades with the inferred normal, so the normal MLP gets
    gradients before its own loss starts and is not start-delayed (its
    schedule keeps the offset).
    """
    decay_steps = lrate_decay * 1000.0
    overrides = group_lr_overrides or {}
    groups = {}
    for name in variables:
        start_spec = GROUP_START_KEYS.get(name, 0)
        if isinstance(start_spec, str):
            start = getattr(lcfg, start_spec) if lcfg is not None else 0
        else:
            start = start_spec
        delay = start
        if name == "roughness_mlp" and lcfg is not None and lcfg.initialize_roughness:
            delay = 0
        if name == "normal_mlp" and normal_feeds_shading:
            delay = 0
        groups[name] = GroupOptimizer(
            lrate=overrides.get(name, lrate), decay_steps=decay_steps,
            start=0 if delay > 0 else start, delay=max(delay, 0))
    return NamedAdam(groups)


def init_train_state(variables: dict, optimizer: NamedAdam, step: int = 0) -> TrainState:
    """A state owning f32 copies of `variables` that require grad."""
    own = _unflatten(variables, [p.detach().clone().requires_grad_(True)
                                 for p in _leaves(variables)])
    return TrainState(variables=own, opt_state=optimizer.init(own), step=step)


def phase_render_config(rcfg: RenderConfig, phase: Phase) -> RenderConfig:
    """Specialize the render config to a training phase."""
    return rcfg.replace(
        approximate_radiance=phase.approximate_radiance,
        freeze_radiance=phase.freeze_radiance,
        freeze_roughness=phase.freeze_roughness,
    )


def draw_volume_uniforms(n_vol: int, rcfg: RenderConfig, device,
                         generator: torch.Generator | None = None,
                         dtype: torch.dtype = torch.float32) -> dict:
    """The draws of the depth-volume pass: "dirs" (n_vol, 3) uniforms of
    its directions (JAX draws (B, 3) from k_vol and keeps the first
    n_vol rows) and, under perturb or raw_noise_std, "render", its
    render_rays draws (JAX's k_vol_render)."""
    out = {"dirs": torch.rand((n_vol, 3), device=device, generator=generator, dtype=dtype)}
    if render_draws_needed(rcfg):
        out["render"] = draw_render_uniforms(n_vol, rcfg, device, generator, dtype)
    return out


def depth_volume_pass(variables, consts, normal, rays_o, rays_d, depth_map,
                      rcfg: RenderConfig, near, far, n_vol: int, draws: dict) -> dict:
    """The random-volume pass of the depth distillation loss (NeRV-style):
    the first n_vol rays restart at their detached expected surface
    points along random directions turned into the gt normal's
    hemisphere (`normal` stored as (n + 1) / 2) and render depth-only,
    with the inferred depth; their depth is detached."""
    normal_map = 2.0 * normal[:n_vol] - 1.0
    normal_map = normal_map / torch.clamp(
        torch.linalg.vector_norm(normal_map, dim=-1, keepdim=True), min=1e-12)
    x_surface = (rays_o[:n_vol] + rays_d[:n_vol] * depth_map[:n_vol, None]).detach()
    rand_dir = 2.0 * draws["dirs"][:n_vol] - 1.0
    rand_dir = torch.sign(torch.sum(rand_dir * normal_map, -1))[..., None] * rand_dir
    rand_dir = rand_dir / torch.clamp(
        torch.linalg.vector_norm(rand_dir, dim=-1, keepdim=True), min=1e-12)
    result = render_rays(variables, consts, make_ray_batch(x_surface, rand_dir, near, far),
                         rcfg, is_depth_only=True, draws=draws.get("render"))
    result["depth_map"] = result["depth_map"].detach()
    return result


def loss_from_batch(variables, consts, pixel_info, rays_o, rays_d,
                    rcfg_phase: RenderConfig, lcfg: LossConfig, phase: Phase,
                    prior_irradiance_mean: float, near, far,
                    draws: dict | None = None, n_vol: int = 256,
                    vol_draws: dict | None = None, vol_weight: float = 1.0):
    """Render, the depth-volume pass (when the depth loss is on, the
    batch has gt normals and n_vol > 0) and the loss for an
    already-sampled pixel batch, which is also the renderer's gt inputs.
    `draws` as `render_rays` takes them; `vol_draws` as
    `draw_volume_uniforms` makes them, for the batch's first n_vol rays
    (drawn on the rays' device when absent); `vol_weight` as
    compute_losses' depth_volume_weight."""
    batch = make_ray_batch(rays_o, rays_d, near, far)
    result = render_rays(variables, consts, batch, rcfg_phase, draws=draws,
                         gt_values=pixel_info)
    depth_volume_result = None
    if phase.depth_loss_on and "normal" in pixel_info and n_vol > 0:
        with span("train.depth_volume"):
            depth_volume_result = depth_volume_pass(
                variables, consts, pixel_info["normal"], rays_o, rays_d, result["depth_map"],
                rcfg_phase, near, far, n_vol,
                vol_draws or draw_volume_uniforms(n_vol, rcfg_phase, rays_o.device))
    return compute_losses(result, pixel_info, lcfg, phase, prior_irradiance_mean, far,
                          depth_volume_result=depth_volume_result,
                          depth_volume_weight=vol_weight)


@torch.no_grad()
def patch_depth_smoothness(variables, consts, rays_o_n, rays_d_n, rcfg: RenderConfig,
                           near, far, draws: dict | None = None) -> torch.Tensor:
    """The mean over pixels of the population std of their 8 neighbours'
    depths, rendered depth-only without a graph from (B, 8, 3) rays."""
    b = rays_o_n.shape[0]
    nres = render_rays(variables, consts,
                       make_ray_batch(rays_o_n.reshape(-1, 3), rays_d_n.reshape(-1, 3),
                                      near, far),
                       rcfg, is_depth_only=True, draws=draws)
    return torch.mean(torch.std(nres["depth_map"].reshape(b, 8), dim=-1, correction=0))


def value_and_grads(loss_fn, variables, *args):
    """(total, scalars, grads) of `loss_fn(variables, *args)`: grads as a
    list over `_leaves(variables)`, zeros for a param the loss does not
    reach (as jax.grad gives), and the scalars detached."""
    with span("train.forward"):
        total, scalars = loss_fn(variables, *args)
    leaves = _leaves(variables)
    with span("train.backward"):
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    scalars = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in scalars.items()}
    return total.detach(), scalars, grads


def make_optimizer_step(optimizer: NamedAdam, reduce=None):
    """Wrap a `loss_fn(variables, draws, *batch) -> (total, scalars)` into
    `train_step(state, draws, *batch) -> (state, scalars)`: the gradients
    of the total, then one Adam update of the state in place.
    `reduce(grads, scalars) -> (grads, scalars)`, when given, combines
    the gradients (a list over the params' leaves) and the scalars across
    processes before the update."""
    def build(loss_fn):
        def train_step(state: TrainState, draws: dict, *batch):
            _, scalars, grads = value_and_grads(loss_fn, state.variables, draws, *batch)
            with span("train.optimizer"):
                if reduce is not None:
                    grads, scalars = reduce(grads, scalars)
                optimizer.update_(state.variables, _unflatten(state.variables, grads),
                                  state.opt_state)
            state.step += 1
            return state, scalars
        return train_step
    return build


class TrainStep:
    """One phase's train step. `step(state, arrays)` samples, renders,
    takes the loss and its gradients and applies Adam in place; it
    returns (state, scalars)."""

    def __init__(self, rcfg, lcfg, phase, optimizer, consts, H, W, batch_size,
                 prior_irradiance_mean, near, far, precrop, precrop_frac,
                 merged_sampling=False, n_depth_random_volume=256, patch=False):
        self.rcfg = phase_render_config(rcfg, phase)
        self.lcfg, self.phase, self.optimizer, self.consts = lcfg, phase, optimizer, consts
        self.H, self.W, self.batch_size = H, W, batch_size
        self.prior_irradiance_mean, self.near, self.far = prior_irradiance_mean, near, far
        self.precrop, self.precrop_frac = precrop, precrop_frac
        self.merged_sampling, self.patch = merged_sampling, patch
        self.n_vol = min(n_depth_random_volume, batch_size)
        self._update = make_optimizer_step(optimizer)(
            lambda variables, draws, arrays: self.loss(variables, arrays, draws))

    def draw_render(self, device, generator: torch.Generator | None = None,
                    volume: bool = True) -> dict:
        """The step's draws past the pixels: "render" (under perturb or
        raw_noise_std), "vol" when `volume` and the phase runs the
        depth-volume pass, and "patch" (the neighbour pass's render draws,
        JAX's k_patch) under patch sampling."""
        draws = {}
        if render_draws_needed(self.rcfg):
            draws["render"] = draw_render_uniforms(self.batch_size, self.rcfg, device,
                                                   generator)
        if self.phase.depth_loss_on and volume:
            draws["vol"] = draw_volume_uniforms(self.n_vol, self.rcfg, device, generator)
        if self.patch and render_draws_needed(self.rcfg):
            draws["patch"] = draw_render_uniforms(8 * self.batch_size, self.rcfg, device,
                                                  generator)
        return draws

    def draw(self, arrays: dict, generator: torch.Generator | None = None) -> dict:
        """Every random number of one step: {"pixels": ...} and
        `draw_render`'s (the volume pass's when the arrays hold normals)."""
        images = arrays["images"]
        draws = {"pixels": draw_pixels(images.shape[0], self.batch_size, self.H, self.W,
                                       images.device, generator, self.precrop,
                                       self.precrop_frac, self.merged_sampling, self.patch)}
        draws.update(self.draw_render(images.device, generator, volume="normal" in arrays))
        return draws

    def sample(self, arrays: dict, pixels: dict) -> tuple:
        """The pixel batch of `pixels` draws: (pixel_info, rays_o,
        rays_d), and the neighbours' (neigh_info, rays_o_n, rays_d_n)
        under patch sampling."""
        return sample_pixel_batch(arrays, self.batch_size, self.H, self.W, self.precrop,
                                  self.precrop_frac, patch=self.patch,
                                  merged=self.merged_sampling, draws=pixels)

    def batch_loss(self, variables: dict, consts: dict, batch: tuple, draws: dict,
                   n_vol: int | None = None, vol_weight: float = 1.0):
        """(total, scalars) of a sampled batch (`sample`'s tuple) with a
        graph to the params; the depth-volume pass takes the batch's first
        n_vol rays (the step's n_vol when None)."""
        pixel_info, rays_o, rays_d = batch[:3]
        total, scalars = loss_from_batch(
            variables, consts, pixel_info, rays_o, rays_d, self.rcfg, self.lcfg, self.phase,
            self.prior_irradiance_mean, self.near, self.far, draws=draws.get("render"),
            n_vol=self.n_vol if n_vol is None else n_vol, vol_draws=draws.get("vol"),
            vol_weight=vol_weight)
        if self.patch:
            scalars = dict(scalars, patch_depth_smoothness=patch_depth_smoothness(
                variables, consts, batch[4], batch[5], self.rcfg, self.near, self.far,
                draws.get("patch")))
        return total, scalars

    def loss(self, variables: dict, arrays: dict, draws: dict):
        """(total, scalars) of one batch, with a graph to the params."""
        return self.batch_loss(variables, self.consts, self.sample(arrays, draws["pixels"]),
                               draws)

    def loss_and_grads(self, variables: dict, arrays: dict, draws: dict):
        """(total, scalars, grads): grads mirror `variables`; a param the
        loss does not reach gets zeros, as jax.grad gives."""
        total, scalars, grads = value_and_grads(
            lambda v: self.loss(v, arrays, draws), variables)
        return total, scalars, _unflatten(variables, grads)

    def __call__(self, state: TrainState, arrays: dict, draws: dict | None = None,
                 generator: torch.Generator | None = None):
        with span("train.update", unit=state.step):
            if draws is None:
                draws = self.draw(arrays, generator)
            return self._update(state, draws, arrays)


def make_train_step(
    rcfg: RenderConfig,
    lcfg: LossConfig,
    phase: Phase,
    optimizer: NamedAdam,
    consts: dict,
    H: int,
    W: int,
    batch_size: int,
    prior_irradiance_mean: float,
    near: float,
    far: float,
    precrop: bool = False,
    precrop_frac: float = 0.5,
    merged_sampling: bool = False,
    n_depth_random_volume: int = 256,
    patch: bool = False,
) -> TrainStep:
    """The train step of one phase; it updates its state in place.
    merged_sampling draws an image per ray; the depth-volume pass renders
    min(n_depth_random_volume, batch_size) rays; patch samples pixels
    with their 8 neighbours (single-image) and logs
    patch_depth_smoothness."""
    return TrainStep(rcfg, lcfg, phase, optimizer, consts, H, W, batch_size,
                     prior_irradiance_mean, near, far, precrop, precrop_frac,
                     merged_sampling, n_depth_random_volume, patch)
