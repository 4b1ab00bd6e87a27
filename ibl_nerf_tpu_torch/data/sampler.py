"""Pixel-batch sampling for the train step.

Counterpart of ibl_nerf_tpu/data/sampler.py: the dataset lives on the
device once; each step draws one image index (or, merged, one per ray)
and `batch_size` pixel columns and rows, gathers their colours, K
prefiltered targets and gt buffers, and builds their rays. Where the JAX
sampler derives the indices from a PRNG key, this one takes them from a
`torch.Generator` or as a `draws` dict, so a test can hand both sides
the same indices. `patch` sampling is not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from ibl_nerf_tpu_torch.ops.rays import get_rays_for_pixels
from ibl_nerf_tpu_torch.utils.device import resolve_device

_GT_BUFFERS = ("normal", "albedo", "roughness", "depth", "irradiance", "prior_albedo")


def device_arrays_from_scene(scene, include: tuple[str, ...] = (),
                             device: str | torch.device | None = None) -> dict[str, Any]:
    """The scene buffers the sampler reads, as f32 tensors on `device`
    (CUDA unless named). include: extra gt buffer names from
    scene.gt_buffers()."""
    device = resolve_device(device)

    def conv(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device)

    arrays = {"images": conv(scene.images), "poses": conv(scene.poses),
              "K": conv(scene.focal_matrix())}
    if scene.prefiltered_images is not None:
        arrays["prefiltered_images"] = conv(scene.prefiltered_images)
    buffers = scene.gt_buffers()
    arrays.update({k: conv(buffers[k]) for k in include if k in buffers})
    return arrays


def pixel_bounds(H: int, W: int, precrop: bool = False,
                 precrop_frac: float = 0.5) -> tuple[int, int, int, int]:
    """(sH, eH, sW, eW): the rows and columns pixels are drawn from."""
    if not precrop:
        return 0, H, 0, W
    dH, dW = int(H // 2 * precrop_frac), int(W // 2 * precrop_frac)
    return (max(H // 2 - dH, 0), min(H // 2 + dH, H),
            max(W // 2 - dW, 0), min(W // 2 + dW, W))


def draw_pixels(n_images: int, batch_size: int, H: int, W: int, device,
                generator: torch.Generator | None = None,
                precrop: bool = False, precrop_frac: float = 0.5,
                merged: bool = False) -> dict:
    """One batch's indices: "img" (an int64 scalar, or (batch_size,) when
    merged: an image per ray), "u" (columns) and "v" (rows),
    (batch_size,) int64 each."""
    sH, eH, sW, eW = pixel_bounds(H, W, precrop, precrop_frac)

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
    Returns (pixel_info, rays_o, rays_d).
    """
    if patch:
        raise NotImplementedError("patch sampling is not ported to ibl_nerf_tpu_torch yet")
    images = arrays["images"]
    if draws is None:
        draws = draw_pixels(images.shape[0], batch_size, H, W, images.device,
                            generator, precrop, precrop_frac, merged)
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
    c2w = arrays["poses"][img][..., :3, :4]
    rays_o, rays_d = get_rays_for_pixels(uv, arrays["K"], c2w)
    return pixel_info, rays_o, rays_d
