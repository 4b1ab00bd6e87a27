"""Trajectory rendering: a novel-view video from a checkpoint.

    python -m ibl_nerf_tpu_torch.cli.render --config <scene config> \
        [--trajectory orbit|spiral|lemniscate --orbit_frames 60 \
         --orbit_phi -30 --orbit_radius 4]

Counterpart of `python -m ibl_nerf_tpu.cli.render`: renders the camera
trajectory around the origin with the scene's intrinsics, writes every
buffer as `{trajectory}_{step:06d}/{name}_{idx:03d}.png` in the run's
logdir, and `rgb.avi`, `radiance.avi` and `albedo.avi` beside them
(`utils/video.py`). The poses have no aligned ground truth, so the gt
buffers are dropped, the gt substitutions are off, and a
`ground_truth` normal type renders with ε normals instead. Runs on the
CUDA device and raises when there is none.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ibl_nerf_tpu_torch.cli.config import parse_with_includes
from ibl_nerf_tpu_torch.cli.test import restore_for_eval
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.data.dataset import load_scene
from ibl_nerf_tpu_torch.eval.render_path import render_path
from ibl_nerf_tpu_torch.ops.geometry import pose_spherical
from ibl_nerf_tpu_torch.render.renderer import _check_supported
from ibl_nerf_tpu_torch.train.loop import field_config_from_args, render_config_from_args
from ibl_nerf_tpu_torch.utils.device import resolve_device
from ibl_nerf_tpu_torch.utils.logging import load_logger
from ibl_nerf_tpu_torch.utils.video import export_stack_as_video


def orbit_poses(n_frames: int, phi: float, radius: float) -> np.ndarray:
    return np.stack([
        pose_spherical(theta, phi, radius)
        for theta in np.linspace(-180.0, 180.0, n_frames, endpoint=False)
    ])


def spiral_poses(n_frames: int, phi: float, radius: float,
                 n_turns: float = 2.0, phi_amp: float = 15.0) -> np.ndarray:
    """theta sweeps n_turns revolutions while the elevation oscillates
    +-phi_amp around phi."""
    t = np.linspace(0.0, 1.0, n_frames, endpoint=False)
    return np.stack([
        pose_spherical(-180.0 + 360.0 * n_turns * ti,
                       phi + phi_amp * np.sin(2.0 * np.pi * ti),
                       radius)
        for ti in t
    ])


def lemniscate_poses(n_frames: int, phi: float, radius: float,
                     theta_amp: float = 60.0,
                     phi_amp: float = 20.0) -> np.ndarray:
    """A figure eight (Gerono's lemniscate in angle space) centred on
    (theta=0, phi)."""
    t = np.linspace(0.0, 2.0 * np.pi, n_frames, endpoint=False)
    return np.stack([
        pose_spherical(theta_amp * np.sin(ti),
                       phi + phi_amp * np.sin(ti) * np.cos(ti),
                       radius)
        for ti in t
    ])


TRAJECTORIES = {
    "orbit": orbit_poses,
    "spiral": spiral_poses,
    "lemniscate": lemniscate_poses,
}


def main(argv=None, device=None) -> dict:
    """Render a trajectory from the newest checkpoint on `device` (CUDA
    unless named); returns render_path's buffers."""
    device = resolve_device(device)
    logger = load_logger("render")
    raw = list(argv if argv is not None else sys.argv[1:])

    def pop_flag(name, default, cast):
        if name in raw:
            i = raw.index(name)
            val = cast(raw[i + 1])
            del raw[i:i + 2]
            return val
        return default

    n_frames = pop_flag("--orbit_frames", 60, int)
    phi = pop_flag("--orbit_phi", -30.0, float)
    radius = pop_flag("--orbit_radius", 4.0, float)
    traj = pop_flag("--trajectory", "orbit", str)
    if traj not in TRAJECTORIES:
        raise SystemExit(f"--trajectory must be one of {sorted(TRAJECTORIES)}")

    args = parse_with_includes(raw)
    fcfg = field_config_from_args(args)
    rcfg = render_config_from_args(args, fcfg).replace(
        approximate_radiance=True, perturb=False, raw_noise_std=0.0,
        normal_type=(args.calculating_normal_type
                     if args.calculating_normal_type != "ground_truth"
                     else "normal_map_from_depth_gradient_epsilon"),
        depth_map_from_ground_truth=False,
        calculate_albedo_from_gt=False,
        calculate_roughness_from_gt=False,
        calculate_irradiance_from_gt=False)
    _check_supported(rcfg)

    scene = load_scene(
        args.dataset_type, args.datadir, split="test",
        image_scale=args.image_scale,
        coarse_radiance_number=args.coarse_radiance_number,
        near_plane=args.near_plane, far_plane=args.far_plane,
        load_depth_range_from_file=args.load_depth_range_from_file,
        skip=args.testskip or 1,
    )
    state, step, logdir = restore_for_eval(args, fcfg, device)

    poses = TRAJECTORIES[traj](n_frames, phi, radius)
    outdir = os.path.join(logdir, f"{traj}_{step:06d}")
    scene.normals = scene.albedos = scene.roughness = None
    scene.depths = scene.irradiances = None
    consts = {"brdf_lut": load_brdf_lut(device=device)}
    results = render_path(state.variables, consts, scene, rcfg, savedir=outdir,
                          render_factor=args.render_factor, poses=poses)
    for buf in ("rgb", "radiance", "albedo"):
        if buf in results and results[buf].ndim == 4:
            export_stack_as_video(results[buf], os.path.join(outdir, f"{buf}.avi"))
    logger.info("%s rendered to %s (%d frames)", traj, outdir, n_frames)
    return results


if __name__ == "__main__":
    main()
