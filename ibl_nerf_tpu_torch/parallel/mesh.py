"""Data parallelism over the devices of one process.

Counterpart of ibl_nerf_tpu/parallel/mesh.py. A "mesh" here is an
ordered list of `torch.device`s (a device may appear more than once).
The global ray batch is sampled once, with the global draws, on the
first device; its rays are cut into equal contiguous shards, one per
mesh entry; each shard renders, takes its loss and backpropagates on its
device; the shards' gradients meet on the first device as the gradient
of the global batch's loss; one Adam update runs there and the next step
copies the params out again. Coarse-to-fine resampling, the normal
sweeps, the reflected march and the patch neighbour pass are per-ray
work, so each stays on its shard's device.

JAX states this with `NamedSharding`s and lets XLA insert the gradient
psum. torch has no counterpart of a sharding: `replicate` returns one
copy of a tensor tree per device and `shard_rays` one contiguous slice
of a ray tensor per device, and the step moves tensors itself. The
copies of the params are differentiable (`Tensor.to`), so autograd sums
the shards' gradients into the first device's params.

Every term of train/losses.compute_losses is a mean over rays, so the
global loss is the sum of the shards' losses, each weighted by its share
of the batch. The depth-volume term averages over the global batch's
first n_vol rays (n_vol rounded down to a multiple of the mesh size, as
in JAX), which sit in the first shards: a shard weighs its share of
those rays instead.
"""

from __future__ import annotations

import torch

from ibl_nerf_tpu_torch.render.renderer import render_rays
from ibl_nerf_tpu_torch.train.step import TrainStep, _leaves, _unflatten, make_optimizer_step
from ibl_nerf_tpu_torch.utils.device import resolve_device


def make_mesh(devices=None) -> list[torch.device]:
    """The mesh: `devices` (names or torch.devices) as an ordered list of
    torch.devices, or every CUDA device of the process when None."""
    if devices is None:
        resolve_device("cuda")
        devices = range(torch.cuda.device_count())
        return [torch.device("cuda", i) for i in devices]
    return [torch.device(d) for d in devices]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def replicate(tree, mesh: list[torch.device]) -> list:
    """One copy of a tensor tree per mesh device (differentiable copies;
    a tensor already on a device is that device's copy)."""
    return [_map(lambda x, d=d: x.to(d), tree) for d in mesh]


def shard_rays(x: torch.Tensor, mesh: list[torch.device]) -> list[torch.Tensor]:
    """Equal contiguous row blocks of `x`, one on each mesh device."""
    n = len(mesh)
    assert x.shape[0] % n == 0, (x.shape, n)
    return [part.to(d) for part, d in zip(torch.chunk(x, n), mesh)]


def mesh_n_vol(n_depth_random_volume: int, batch_size: int, n_dev: int) -> int:
    """The depth-volume pass's ray count under a mesh of n_dev devices:
    min(n_depth_random_volume, batch_size), rounded down to a multiple of
    n_dev, at least n_dev."""
    n_vol = min(n_depth_random_volume, batch_size)
    return max(n_vol - n_vol % n_dev, n_dev)


def shard_draws(draws: dict, lo: int, hi: int, n_vol: int, patch: bool) -> dict:
    """A shard's rows of a step's global draws (not "pixels"): the render
    draws of rays [lo, hi), the volume draws of those among the first
    n_vol, the neighbour draws of rays [8 lo, 8 hi)."""
    def rows(d, a, b):
        return _map(lambda x: x[a:b], d)

    out = {}
    if "render" in draws:
        out["render"] = rows(draws["render"], lo, hi)
    if "vol" in draws and lo < n_vol:
        out["vol"] = rows(draws["vol"], lo, min(hi, n_vol))
    if patch and "patch" in draws:
        out["patch"] = rows(draws["patch"], 8 * lo, 8 * hi)
    return out


def shard_losses(step: TrainStep, variables, consts_by_shard, batch: tuple, draws: dict,
                 shards, n_vol: int):
    """(total, scalars) of the global batch from its shards: `shards` is
    a list of (device, lo, hi) row ranges of `batch` (`step.sample`'s
    tuple) and of `draws`; each renders on its device with its copy of
    the params, and the sum, each shard weighted by its share of the
    batch, is taken on the first shard's device."""
    B = step.batch_size
    total, scalars = 0.0, {}
    out_dev = shards[0][0]
    for (dev, lo, hi), consts in zip(shards, consts_by_shard):
        share = (hi - lo) / B
        n_here = max(0, min(hi, n_vol) - lo)
        part = _map(lambda x: x[lo:hi].to(dev), list(batch))
        t, sc = step.batch_loss(
            _map(lambda p: p.to(dev), variables), consts, part,
            _map(lambda x: x.to(dev), shard_draws(draws, lo, hi, n_vol, step.patch)),
            n_vol=n_here, vol_weight=(n_here / n_vol) / share)
        total = total + share * t.to(out_dev)
        for k, v in sc.items():
            v = v.to(out_dev) if isinstance(v, torch.Tensor) else v
            scalars[k] = scalars.get(k, 0.0) + share * v
    return total, scalars


class ShardedTrainStep:
    """The train step of one phase over a mesh, called as TrainStep is:
    `step(state, arrays, draws=None, generator=None)`; the state and the
    arrays live on the mesh's first device."""

    def __init__(self, rcfg, lcfg, phase, optimizer, consts, H, W, batch_size,
                 prior_irradiance_mean, near, far, mesh, precrop=False, precrop_frac=0.5,
                 merged_sampling=False, n_depth_random_volume=256, patch=False):
        n_dev = len(mesh)
        assert batch_size % n_dev == 0, (batch_size, n_dev)
        self.mesh = list(mesh)
        self.n_vol = mesh_n_vol(n_depth_random_volume, batch_size, n_dev)
        self.step = TrainStep(rcfg, lcfg, phase, optimizer, consts, H, W, batch_size,
                              prior_irradiance_mean, near, far, precrop, precrop_frac,
                              merged_sampling, self.n_vol, patch)
        self.consts = replicate(consts, self.mesh)
        b = batch_size // n_dev
        self.shards = [(d, s * b, (s + 1) * b) for s, d in enumerate(self.mesh)]
        self._update = make_optimizer_step(optimizer)(self.loss)

    def draw(self, arrays: dict, generator: torch.Generator | None = None) -> dict:
        return self.step.draw(arrays, generator)

    def loss(self, variables: dict, draws: dict, arrays: dict):
        """(total, scalars) of the global batch, from its shards."""
        batch = self.step.sample(arrays, draws["pixels"])
        return shard_losses(self.step, variables, self.consts, batch, draws, self.shards,
                            self.n_vol)

    def __call__(self, state, arrays: dict, draws: dict | None = None,
                 generator: torch.Generator | None = None):
        if draws is None:
            draws = self.draw(arrays, generator)
        return self._update(state, draws, arrays)


def make_sharded_train_step(
    rcfg, lcfg, phase, optimizer, consts, H, W, batch_size,
    prior_irradiance_mean, near, far, mesh: list[torch.device],
    precrop: bool = False, precrop_frac: float = 0.5,
    merged_sampling: bool = False,
    n_depth_random_volume: int = 256,
    patch: bool = False,
):
    """(train_step, place_state, place_arrays): the step of one phase
    with its rays sharded over `mesh` (batch_size must divide by its
    size), and the functions that move a TrainState and the dataset to
    the mesh's first device. patch: each shard renders its own pixels'
    neighbour rays."""
    step = ShardedTrainStep(rcfg, lcfg, phase, optimizer, consts, H, W, batch_size,
                            prior_irradiance_mean, near, far, mesh, precrop, precrop_frac,
                            merged_sampling, n_depth_random_volume, patch)
    first = step.mesh[0]

    def place_state(state):
        state.variables = _unflatten(state.variables, [
            p.detach().to(first).requires_grad_(True) for p in _leaves(state.variables)])
        for st in state.opt_state.values():
            st.mu = [m.to(first) for m in st.mu]
            st.nu = [v.to(first) for v in st.nu]
        return state

    def place_arrays(arrays: dict) -> dict:
        return {k: v.to(first) for k, v in arrays.items()}

    return step, place_state, place_arrays


def make_sharded_render_fn(mesh: list[torch.device], variables, consts, rcfg):
    """A chunk renderer for render_image(render_fn=): the chunk's rays
    are cut into contiguous parts, one per mesh device, rendered there
    without a graph and gathered in order on the chunk's device."""
    mesh = list(mesh)
    variables_by_dev = replicate(_map(lambda p: p.detach(), variables), mesh)
    consts_by_dev = replicate(consts, mesh)

    @torch.no_grad()
    def render_fn(batch: dict, gt: dict | None):
        home = batch["rays_o"].device
        n = len(mesh)
        parts = []
        for s, dev in enumerate(mesh):
            def piece(x, s=s, dev=dev):
                return torch.tensor_split(x, n)[s].to(dev)
            out = render_rays(variables_by_dev[s], consts_by_dev[s],
                              {k: piece(v) for k, v in batch.items()}, rcfg,
                              gt_values={k: piece(v) for k, v in gt.items()} if gt else None)
            parts.append(out)
        return {k: torch.cat([p[k].to(home) for p in parts]) for k in parts[0]}

    return render_fn
