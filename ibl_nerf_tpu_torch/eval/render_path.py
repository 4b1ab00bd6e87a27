"""Full test-path rendering.

Counterpart of ibl_nerf_tpu/eval/render_path.py on its fast path: every
pose is rendered as one whole frame with the coarse pass density-only
and only the exported buffers kept, with the same display transforms
(normals -> (n+1)/2, depth -> disparity via far*0.1), the `acc`
coverage buffer and the screen-space normal-from-depth buffer.

Not ported yet: PNG export (`savedir`), which needs an image encoder,
and the `fast=False` per-chunk path. The gt buffers of a scene are not
read: no mode the port covers consumes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ibl_nerf_tpu_torch.ops.geometry import depth_to_normal_image_space
from ibl_nerf_tpu_torch.ops.rays import get_rays_full_image
from ibl_nerf_tpu_torch.render.renderer import make_frame_render_fn, render_frame

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

    `scene` is any object with height, width, focal, near, far and
    poses ((N, 3|4, 4) camera-to-world). The frames render on the device
    of `consts["brdf_lut"]`. render_factor > 1 renders downsampled
    (focal rescaled).
    """
    if savedir is not None:
        raise NotImplementedError("savedir (PNG export) is not ported to "
                                  "ibl_nerf_tpu_torch yet")
    if not fast:
        raise NotImplementedError("fast=False is not ported to "
                                  "ibl_nerf_tpu_torch yet")
    H, W, focal = scene.height, scene.width, scene.focal
    if render_factor not in (0, 1):
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor
    device = consts["brdf_lut"].device
    K = torch.tensor([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    render_poses = poses if poses is not None else scene.poses

    kk = rcfg.field.coarse_radiance_number
    export_keys = tuple(k for k, _ in _EXPORTS) + ("acc_map",) + tuple(
        f"radiance_map_{k + 1}" for k in range(kk)) + tuple(
        f"reflected_coarse_radiance_map_{k + 1}" for k in range(kk))
    frame_fn = make_frame_render_fn(
        variables, consts,
        rcfg.replace(perturb=False, raw_noise_std=0.0, coarse_shading=False),
        output_keys=export_keys)

    results: dict[str, list] = {}

    def append(res, key_name, out_name):
        if key_name not in res:
            return
        img = res[key_name].cpu().numpy()
        if "normal" in out_name or "tangent" in out_name:
            img = (img + 1.0) * 0.5
        elif "depth" in key_name:
            img = img / (scene.far * 0.1)
            img = 1.0 / np.maximum(1e-10, img)
        results.setdefault(out_name, []).append(img)

    for c2w in render_poses:
        c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4], device=device)
        ro, rd = get_rays_full_image(H, W, K, c2w)
        res = render_frame(frame_fn, ro.reshape(-1, 3), rd.reshape(-1, 3),
                           scene.near, scene.far, chunk)
        res = {k: v.reshape(H, W, *v.shape[1:]) for k, v in res.items()}

        for key_name, out_name in _EXPORTS:
            append(res, key_name, out_name)
        # acc coverage for the collapse detector — returned, never saved
        if "acc_map" in res:
            results.setdefault("acc", []).append(res["acc_map"].cpu().numpy())
        for k in range(kk):
            append(res, f"radiance_map_{k + 1}", f"radiance_{k + 1}")
            append(res, f"reflected_coarse_radiance_map_{k + 1}",
                   f"reflected_coarse_radiance_{k + 1}")
        if "depth_map" in res:
            nfd = depth_to_normal_image_space(res["depth_map"], c2w, K)
            append({"normal_map_from_depth_map": nfd},
                   "normal_map_from_depth_map", "normal_from_depth")

    return {k: np.stack(v, 0) for k, v in results.items()}
