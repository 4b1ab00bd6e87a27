"""Full test-path rendering with per-buffer PNG export.

Counterpart of ibl_nerf_tpu/eval/render_path.py: on the fast path every
pose is rendered as one whole frame with the coarse pass density-only
and only the exported buffers kept; with `fast=False` chunk by chunk
through `render_image` with the coarse pass shaded. Both give the same
display transforms (normals -> (n+1)/2, depth -> disparity via
far*0.1), the `acc` coverage buffer and the screen-space
normal-from-depth buffer. The scene's gt buffers go to the renderer per
pose (shrunk with INTER_AREA at render_factor > 1), and with `savedir`
every buffer is written as `{name}_{idx:03d}.png` through the port's
own PNG encoder. With spans on (`utils/timing`) each pose is the span
`render_path.frame` (its unit the pose index) over `render_path.setup`,
`render_path.chunks` and `render_path.export`.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ibl_nerf_tpu_torch.data.resize import area_weights
from ibl_nerf_tpu_torch.ops.color import to8b
from ibl_nerf_tpu_torch.ops.geometry import depth_to_normal_image_space
from ibl_nerf_tpu_torch.ops.rays import get_rays_full_image
from ibl_nerf_tpu_torch.render.renderer import (make_frame_render_fn, render_frame,
                                                render_image)
from ibl_nerf_tpu_torch.utils.png import write_png
from ibl_nerf_tpu_torch.utils.timing import span

# result key -> export name (order matches the reference's exports)
_EXPORTS = [
    ("color_map", "rgb"),
    ("radiance_map", "radiance"),
    ("irradiance_map", "irradiance"),
    ("albedo_map", "albedo"),
    ("reflected_radiance_map", "reflected_radiance"),
    ("prefiltered_reflected_map", "prefiltered_reflected"),
    ("roughness_map", "roughness"),
    ("specular_map", "specular"),
    ("diffuse_map", "diffuse"),
    ("n_dot_v_map", "n_dot_v"),
    ("inferred_normal_map", "inferred_normal_map"),
    ("target_normal_map", "target_normal_map"),
    ("inferred_depth_map", "inferred_disp"),
    ("disp_map", "disp"),
    ("depth_map", "depth"),
    ("target_depth_map", "target_depth"),
]


@functools.lru_cache(maxsize=8)
def _area_weights(src: int, dst: int, device) -> torch.Tensor:
    """`data/resize.area_weights` as a float64 tensor on `device`."""
    return torch.as_tensor(area_weights(src, dst), device=device)


def _resize_gt(buffers: dict[str, np.ndarray], i: int, factor: int, device) -> dict:
    """Pose i's gt buffers shrunk by 1/factor (INTER_AREA), flattened to
    (H*W, C) f32 tensors on `device`. The shrink runs on `device`, as
    `data/resize.resize` computes it: wy @ img @ wx^T in float64 with
    OpenCV's area weights, cast to float32."""
    out = {}
    for k, stack in buffers.items():
        img = torch.as_tensor(np.ascontiguousarray(stack[i]), device=device)
        if factor != 1:
            h, w = img.shape[:2]
            wy, wx = _area_weights(h, h // factor, device), _area_weights(w, w // factor, device)
            img = torch.tensordot(wy, img.double(), dims=([1], [0]))          # (dh, W, C)
            img = torch.tensordot(wx, img, dims=([1], [1])).movedim(0, 1)     # (dh, dw, C)
        out[k] = img.reshape(-1, img.shape[-1]).float()
    return out


def save_image(savedir: str, name: str, idx: int, img: np.ndarray) -> None:
    """One exported buffer as `{name}_{idx:03d}.png`, 8-bit, RGB or gray."""
    out8 = to8b(img)
    if not (out8.ndim == 3 and out8.shape[-1] == 3):
        out8 = out8.squeeze()
    write_png(os.path.join(savedir, f"{name}_{idx:03d}.png"), out8)


def render_path(
    variables,
    consts,
    scene,
    rcfg,
    savedir: str | None = None,
    render_factor: int = 1,
    chunk: int = 2048,
    poses=None,
    fast: bool = True,
):
    """Render all poses of `scene`; returns {name: (N, H, W, C?) stack}.

    `scene` is any object with height, width, focal, near, far, poses
    ((N, 3|4, 4) camera-to-world) and gt_buffers(). The frames render on
    the device of `consts["brdf_lut"]`. render_factor > 1 renders
    downsampled (focal rescaled). With `savedir` each buffer of each
    pose is also written there as a PNG.

    fast=True renders each frame through make_frame_render_fn with the
    coarse pass weights-only and only the exported buffers kept; every
    exported buffer equals the fast=False render, which shades the
    coarse pass too and renders chunk by chunk through render_image.
    """
    H, W, focal = scene.height, scene.width, scene.focal
    if render_factor not in (0, 1):
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor
    factor = render_factor if render_factor not in (0, 1) else 1
    device = consts["brdf_lut"].device
    K = torch.tensor([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    if savedir is not None:
        os.makedirs(savedir, exist_ok=True)
    gt_buffers = scene.gt_buffers()
    render_poses = poses if poses is not None else scene.poses

    kk = rcfg.field.coarse_radiance_number
    rcfg_test = rcfg.replace(perturb=False, raw_noise_std=0.0)
    if fast:
        export_keys = tuple(k for k, _ in _EXPORTS) + ("acc_map",) + tuple(
            f"radiance_map_{k + 1}" for k in range(kk)) + tuple(
            f"reflected_coarse_radiance_map_{k + 1}" for k in range(kk))
        frame_fn = make_frame_render_fn(
            variables, consts, rcfg_test.replace(coarse_shading=False),
            output_keys=export_keys)

    results: dict[str, list] = {}

    def append(res, key_name, idx, out_name):
        if key_name not in res:
            return
        img = res[key_name].cpu().numpy()
        if "normal" in out_name or "tangent" in out_name:
            img = (img + 1.0) * 0.5
        elif "depth" in key_name:
            img = img / (scene.far * 0.1)
            img = 1.0 / np.maximum(1e-10, img)
        results.setdefault(out_name, []).append(img)
        if savedir is not None:
            save_image(savedir, out_name, idx, img)

    def export(res, i, c2w):
        """Pose i's buffers to the host (and to PNGs under `savedir`)."""
        for key_name, out_name in _EXPORTS:
            append(res, key_name, i, out_name)
        # acc coverage for the collapse detector — returned, never saved
        if "acc_map" in res:
            results.setdefault("acc", []).append(res["acc_map"].cpu().numpy())
        for k in range(kk):
            append(res, f"radiance_map_{k + 1}", i, f"radiance_{k + 1}")
            append(res, f"reflected_coarse_radiance_map_{k + 1}", i,
                   f"reflected_coarse_radiance_{k + 1}")
        if "depth_map" in res:
            nfd = depth_to_normal_image_space(res["depth_map"], c2w, K)
            append({"normal_map_from_depth_map": nfd},
                   "normal_map_from_depth_map", i, "normal_from_depth")

    for i, c2w in enumerate(render_poses):
        with span("render_path.frame", unit=i):
            with span("render_path.setup"):
                gt_i = _resize_gt(gt_buffers, i, factor, device) if gt_buffers else None
                c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4], device=device)
                if fast:
                    ro, rd = get_rays_full_image(H, W, K, c2w)
            with span("render_path.chunks"):
                if fast:
                    res = render_frame(frame_fn, ro.reshape(-1, 3), rd.reshape(-1, 3),
                                       scene.near, scene.far, chunk, gt_values=gt_i)
                    res = {k: v.reshape(H, W, *v.shape[1:]) for k, v in res.items()}
                else:
                    res = render_image(variables, consts, H, W, K, c2w, scene.near, scene.far,
                                       rcfg_test, gt_values=gt_i, chunk=chunk)
            with span("render_path.export"):
                export(res, i, c2w)

    return {k: np.stack(v, 0) for k, v in results.items()}
