"""Data parallelism over processes: a `torch.distributed` process group,
a data pipeline sharded by process and a global train step.

Counterpart of ibl_nerf_tpu/parallel/distributed.py:

 - `initialize()` joins the process group over TCP at the coordinator's
   address: NCCL for CUDA tensors, gloo for CPU ones (or the backend the
   caller names). It never falls back from one to the other.
 - Data is sharded by process: each keeps only its slice of the image
   stack (`images[pid::pcount]`) and samples its B/P rays of every
   global batch from it (`HostShardedSampler`). JAX assembles the global
   batch as one array; torch has none, so `sample(step)` returns this
   process's shard.
 - `make_global_train_step` takes the loss of the local shard, sums the
   gradients over the group with one `all_reduce` and divides by P (the
   shards are equal), and runs the same Adam update on every process, so
   the replicas stay bit-identical. The render and depth-volume draws
   follow the global batch's order: every process draws the global
   (B, ...) draws from the same generator and keeps its rows, and the
   volume rays, the global batch's first n_vol, live on the first
   processes. A P-process run thus equals a single-process run on the
   concatenated batch.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ibl_nerf_tpu_torch.data.sampler import draw_pixels, sample_pixel_batch
from ibl_nerf_tpu_torch.parallel.mesh import mesh_n_vol, shard_draws
from ibl_nerf_tpu_torch.train.step import TrainStep, make_optimizer_step


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               device_type: str = "cuda") -> tuple[int, int]:
    """Join the process group; a no-op for one process. Returns
    (process_index, process_count). The backend is NCCL when the
    processes train on CUDA devices and gloo on the CPU, unless named."""
    if num_processes is None or num_processes <= 1:
        return 0, 1
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def process_group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index_and_count() -> tuple[int, int]:
    """(rank, world size) of the live process group, else (0, 1)."""
    if process_group_active():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device(device_type: str = "cuda") -> torch.device:
    """The device this process trains on: the CUDA device of its local
    rank (the process index modulo the host's device count); the CPU
    for device_type "cpu"."""
    if device_type != "cuda":
        return torch.device(device_type)
    rank = process_index_and_count()[0]
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def global_mesh(device_type: str = "cuda") -> list[torch.device]:
    """One device per process, in rank order (what each trains on, as
    `local_device` picks it on a one-host run)."""
    _, count = process_index_and_count()
    if device_type != "cuda":
        return [torch.device(device_type)] * count
    n = max(torch.cuda.device_count(), 1)
    return [torch.device("cuda", r % n) for r in range(count)]


def _tensor_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensor_leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for f in tree.__dataclass_fields__ for x in _tensor_leaves(getattr(tree, f))]
    return [tree] if isinstance(tree, torch.Tensor) else []


@torch.no_grad()
def put_replicated(tree):
    """Broadcast every tensor of `tree` (dicts, lists, dataclasses such
    as a TrainState) from rank 0, in place; returns `tree`. A no-op
    without a process group."""
    if process_group_active():
        for x in _tensor_leaves(tree):
            dist.broadcast(x, src=0)
    return tree


def fetch_replicated(tree):
    """A host numpy copy of a tensor tree (every process holds complete
    replicas, so this never communicates)."""
    if isinstance(tree, dict):
        return {k: fetch_replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [fetch_replicated(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _slice_host_arrays(arrays: dict[str, Any], pid: int, pcount: int) -> dict[str, Any]:
    """This process's image shard: image-indexed buffers keep rows
    [pid::pcount]; the intrinsic matrix K is shared."""
    local = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if k == "K":
            local[k] = v
        elif k == "prefiltered_images":  # (levels, N, H, W, 3)
            local[k] = v[:, pid::pcount]
        else:  # (N, H, W, C) / (N, 4, 4)
            local[k] = v[pid::pcount]
    return local


def _generator(seed: int, step: int, pid: int, device) -> torch.Generator:
    state = np.random.SeedSequence((seed, step, pid)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


class HostShardedSampler:
    """Per-process pixel-batch sampling from this process's image shard.

    Each process samples batch_size/process_count rays from its shard,
    from a generator seeded with (seed, step, process index) -- the
    counterpart of JAX's fold_in(fold_in(key(seed), step), pid) -- so a
    run is reproducible across restarts and can be emulated in one
    process."""

    def __init__(self, arrays: dict[str, Any], batch_size: int, H: int, W: int,
                 process_index: int | None = None, process_count: int | None = None,
                 precrop: bool = False, precrop_frac: float = 0.5, merged: bool = False,
                 seed: int = 42, device: str | torch.device = "cuda"):
        rank, count = process_index_and_count()
        pid = rank if process_index is None else process_index
        pcount = count if process_count is None else process_count
        assert batch_size % pcount == 0, (batch_size, pcount)
        self.pid, self.pcount = pid, pcount
        self.local_batch = batch_size // pcount
        self.H, self.W, self.seed, self.device = H, W, seed, torch.device(device)
        self.precrop, self.precrop_frac, self.merged = precrop, precrop_frac, merged
        local = _slice_host_arrays(arrays, pid, pcount)
        assert local["images"].shape[0] > 0, f"process {pid} has no images (pcount={pcount})"
        self.local_arrays = {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                             for k, v in local.items()}

    def sample(self, step: int):
        """This process's shard of the step's batch: (pixel_info, rays_o,
        rays_d), (B/P, ...) each."""
        gen = _generator(self.seed, step, self.pid, self.device)
        draws = draw_pixels(self.local_arrays["images"].shape[0], self.local_batch, self.H,
                            self.W, self.device, gen, self.precrop, self.precrop_frac,
                            self.merged)
        return sample_pixel_batch(self.local_arrays, self.local_batch, self.H, self.W,
                                  self.precrop, self.precrop_frac, merged=self.merged,
                                  draws=draws)


class GlobalTrainStep:
    """The train step of one phase over a process group:
    `step(state, draws, pixel_info, rays_o, rays_d)` with this process's
    shard of the batch and the global draws of `draw`."""

    def __init__(self, rcfg, lcfg, phase, optimizer, consts, batch_size,
                 prior_irradiance_mean, near, far, n_depth_random_volume=256,
                 process_index: int | None = None, process_count: int | None = None):
        rank, count = process_index_and_count()
        self.pid = rank if process_index is None else process_index
        self.pcount = count if process_count is None else process_count
        assert batch_size % self.pcount == 0, (batch_size, self.pcount)
        self.n_vol = mesh_n_vol(n_depth_random_volume, batch_size, self.pcount)
        self.step = TrainStep(rcfg, lcfg, phase, optimizer, consts, None, None, batch_size,
                              prior_irradiance_mean, near, far, False, 0.5,
                              n_depth_random_volume=self.n_vol)
        b = batch_size // self.pcount
        self.lo, self.hi = self.pid * b, (self.pid + 1) * b
        self._update = make_optimizer_step(optimizer, reduce=self.all_reduce)(self.loss)

    def draw(self, device, generator: torch.Generator | None = None,
             volume: bool = True) -> dict:
        """The global render and depth-volume draws of one step, the same
        on every process that passes the same generator."""
        return self.step.draw_render(device, generator, volume=volume)

    def loss(self, variables: dict, draws: dict, pixel_info, rays_o, rays_d):
        """(total, scalars) of the local shard, weighted so that their
        mean over the processes is the global batch's."""
        n_here = max(0, min(self.hi, self.n_vol) - self.lo)
        share = 1.0 / self.pcount
        return self.step.batch_loss(
            variables, self.step.consts, (pixel_info, rays_o, rays_d),
            shard_draws(draws, self.lo, self.hi, self.n_vol, patch=False),
            n_vol=n_here, vol_weight=(n_here / self.n_vol) / share)

    def all_reduce(self, grads: list, scalars: dict):
        """Sum the gradients and scalars over the group in one all_reduce,
        divided by the process count; identity without a process group."""
        if not process_group_active():
            return grads, scalars
        names = sorted(scalars)
        flat = torch.cat([g.reshape(-1) for g in grads] + [
            torch.as_tensor(scalars[k], dtype=torch.float32, device=grads[0].device).reshape(1)
            for k in names])
        dist.all_reduce(flat)
        flat /= self.pcount
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return out, dict(zip(names, flat[i:]))

    def __call__(self, state, draws: dict, pixel_info, rays_o, rays_d):
        return self._update(state, draws, pixel_info, rays_o, rays_d)


def make_global_train_step(
    rcfg, lcfg, phase, optimizer, consts, batch_size,
    prior_irradiance_mean, near, far, n_depth_random_volume: int = 256,
    process_index: int | None = None, process_count: int | None = None,
):
    """(train_step, place_state): the step over the process group
    (`GlobalTrainStep`), and a function that broadcasts a TrainState
    from rank 0 so every replica starts equal."""
    step = GlobalTrainStep(rcfg, lcfg, phase, optimizer, consts, batch_size,
                           prior_irradiance_mean, near, far, n_depth_random_volume,
                           process_index, process_count)
    return step, put_replicated
