"""Pixel-batch sampling for the train step.

Counterpart of ibl_nerf_tpu/data/sampler.py: the dataset lives on the
device once; each step draws one image index (or, merged, one per ray)
and `batch_size` pixel columns and rows, gathers their colours, K
prefiltered targets and gt buffers, and builds their rays. Where the JAX
sampler derives the indices from a PRNG key, this one takes them from a
`torch.Generator` or as a `draws` dict, so a test can hand both sides
the same indices. `patch` sampling draws from [1, H-1) x [1, W-1) and
also returns the 8 neighbours' colours (and normals) and rays.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ibl_nerf_tpu_torch.ops.rays import get_rays_for_patches, get_rays_for_pixels, neighbor_coords
from ibl_nerf_tpu_torch.utils.device import resolve_device

_GT_BUFFERS = ("normal", "albedo", "roughness", "depth", "irradiance", "prior_albedo")


def device_arrays_from_scene(scene, include: tuple[str, ...] = (),
                             device: str | torch.device | None = None) -> dict[str, Any]:
    """The scene buffers the sampler reads, as f32 tensors on `device`
    (CUDA unless named). include: extra gt buffer names from
    scene.gt_buffers()."""
    device = resolve_device(device)
    return _collect_scene_arrays(
        scene, include, lambda a: torch.as_tensor(a, dtype=torch.float32).to(device))


def host_arrays_from_scene(scene, include: tuple[str, ...] = ()) -> dict[str, Any]:
    """The same buffers as f32 numpy arrays: the multi-process path keeps
    the dataset on the host and moves only its process's image shard
    (parallel/distributed.HostShardedSampler)."""
    return _collect_scene_arrays(scene, include, lambda a: np.asarray(a, dtype=np.float32))


def _collect_scene_arrays(scene, include, conv) -> dict[str, Any]:
    arrays = {"images": conv(scene.images), "poses": conv(scene.poses),
              "K": conv(scene.focal_matrix())}
    if scene.prefiltered_images is not None:
        arrays["prefiltered_images"] = conv(scene.prefiltered_images)
    buffers = scene.gt_buffers()
    arrays.update({k: conv(buffers[k]) for k in include if k in buffers})
    return arrays


def pixel_bounds(H: int, W: int, precrop: bool = False, precrop_frac: float = 0.5,
                 patch: bool = False) -> tuple[int, int, int, int]:
    """(sH, eH, sW, eW): the rows and columns pixels are drawn from.
    Precrop wins over patch, whose pixels keep a neighbour on every side."""
    if precrop:
        dH, dW = int(H // 2 * precrop_frac), int(W // 2 * precrop_frac)
        return (max(H // 2 - dH, 0), min(H // 2 + dH, H),
                max(W // 2 - dW, 0), min(W // 2 + dW, W))
    if patch:
        return 1, H - 1, 1, W - 1
    return 0, H, 0, W


def draw_pixels(n_images: int, batch_size: int, H: int, W: int, device,
                generator: torch.Generator | None = None,
                precrop: bool = False, precrop_frac: float = 0.5,
                merged: bool = False, patch: bool = False) -> dict:
    """One batch's indices: "img" (an int64 scalar, or (batch_size,) when
    merged: an image per ray), "u" (columns) and "v" (rows),
    (batch_size,) int64 each."""
    sH, eH, sW, eW = pixel_bounds(H, W, precrop, precrop_frac, patch)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, device=device, generator=generator)

    return {"img": randint(0, n_images, (batch_size,) if merged else ()),
            "u": randint(sW, eW, (batch_size,)), "v": randint(sH, eH, (batch_size,))}


def sample_pixel_batch(arrays: dict, batch_size: int, H: int, W: int,
                       precrop: bool = False, precrop_frac: float = 0.5,
                       patch: bool = False, merged: bool = False,
                       draws: dict | None = None,
                       generator: torch.Generator | None = None):
    """Draw one training batch: a random image (merged: a random image
    per ray), `batch_size` random pixels (optionally center-cropped),
    their rays and per-pixel gt dict.

    draws: `draw_pixels` output; drawn from `generator` when absent.
    Returns (pixel_info, rays_o, rays_d), and with `patch` also
    (neigh_info, rays_o_n, rays_d_n): the 8 neighbours' "rgb" (and
    "normal" when the arrays hold it), (B, 8, C), and their rays,
    (B, 8, 3) each. Patch sampling is single-image: merged raises.
    """
    if patch and merged:
        raise ValueError("patch sampling draws one image per batch; it cannot be merged")
    images = arrays["images"]
    if draws is None:
        draws = draw_pixels(images.shape[0], batch_size, H, W, images.device,
                            generator, precrop, precrop_frac, merged, patch)
    img, u, v = draws["img"], draws["u"], draws["v"]

    def gather(buf):  # (N, H, W, C) -> (B, C)
        return buf[img, v, u]

    pixel_info = {"rgb": gather(images)}
    if "prefiltered_images" in arrays:
        pref = arrays["prefiltered_images"]  # (K, N, H, W, 3)
        for k in range(pref.shape[0]):
            pixel_info[f"rgb_{k + 1}"] = pref[k][img, v, u]
    for name in _GT_BUFFERS:
        if name in arrays:
            pixel_info[name] = gather(arrays[name])
    if "prior_irradiance" in arrays:
        # the reference takes channel 0 only
        pixel_info["prior_irradiance"] = gather(arrays["prior_irradiance"])[..., 0]

    uv = torch.stack([u, v], dim=1).float()
    # merged: (B, 3, 4), one pose per ray, which get_rays_for_pixels broadcasts
    pose = arrays["poses"][img]
    c2w = pose[..., :3, :4]
    rays_o, rays_d = get_rays_for_pixels(uv, arrays["K"], c2w)
    if not patch:
        return pixel_info, rays_o, rays_d

    uv_n = neighbor_coords(torch.stack([u, v], dim=1))  # (B, 8, 2) int64
    un, vn = uv_n[..., 0], uv_n[..., 1]
    neigh_info = {"rgb": images[img, vn, un]}
    if "normal" in arrays:
        neigh_info["normal"] = arrays["normal"][img, vn, un]
    rays_o_n, rays_d_n = get_rays_for_patches(uv_n.float(), arrays["K"], pose[:3, :4])
    return pixel_info, rays_o, rays_d, neigh_info, rays_o_n, rays_d_n
