"""The port's test and render CLIs, and the trainer's video, against JAX's.

One field (depth 4, width 32, K=2, 8 + 8 samples, float32) is written
as a checkpoint at update 5 for each side: a port checkpoint from the
port's params, a JAX one from the same numbers. Then on the synthetic
Mitsuba scene (2 test frames at 40x52, render factor 4):
- `cli.test`'s `run_test` plain (gt normals), editing frame 1 (albedo
  and roughness constants on object 1, the edit depth) and inserting
  into frame 1 returns every buffer JAX's returns, within atol 5e-4 /
  rtol 1e-3 on the basic maps and 2e-3 / 5e-3 on the shaded ones, and
  writes the same PNG names under `logs_eval/exp/testset_000005`;
- `cli.render`'s `main` over a 3-frame orbit (ε normals in place of the
  gt ones) does the same under `orbit_000005`, with rgb/radiance/albedo
  AVIs beside the PNGs, whose frames decode to the truncated stacks.
Last, a port training run whose test-set render falls on `--i_video`
writes `video_000006.avi`, whose frames are the render's rgb PNGs.
"""

import os
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.cli import render as j_render_cli
from ibl_nerf_tpu.cli import test as j_test_cli
from ibl_nerf_tpu.cli.config import parse_with_includes as j_parse
from ibl_nerf_tpu.train import checkpoint as j_ckpt
from ibl_nerf_tpu.train import loop as j_loop
from ibl_nerf_tpu.train import step as j_step
from ibl_nerf_tpu_torch.cli import render as render_cli
from ibl_nerf_tpu_torch.cli import test as test_cli
from ibl_nerf_tpu_torch.cli.config import parse_with_includes
from ibl_nerf_tpu_torch.train import checkpoint as ckpt_lib
from ibl_nerf_tpu_torch.train import loop
from ibl_nerf_tpu_torch.train import step as t_step
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_scene import make_scene  # noqa: E402

torch.set_num_threads(2)

BASIC_TOL, SHADED_TOL = (5e-4, 1e-3), (2e-3, 5e-3)
SHADED = ("rgb", "specular", "diffuse", "n_dot_v", "target_normal_map", "reflected_radiance",
          "prefiltered_reflected", "normal_from_depth", "reflected_coarse")
STEP = 5


def _argv(scene_dir, base, *extra):
    return ["--datadir", scene_dir, "--basedir", os.path.join(base, "logs"),
            "--expname", "exp", "--netdepth", "4", "--netwidth", "32", "--N_samples", "8",
            "--N_importance", "8", "--coarse_radiance_number", "2",
            "--load_depth_range_from_file", "--render_factor", "4", "--testskip", "1",
            "--compute_dtype", "float32", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scene, and a checkpoint at update 5 on each side from one
    field (visible density: sigma's bias raised by 0.5)."""
    root = tmp_path_factory.mktemp("eval_cli")
    scene_dir = make_scene(str(root / "scene"))
    bases = {side: str(root / side) for side in ("port", "jax")}
    args = j_parse(_argv(scene_dir, bases["jax"]))
    fcfg = j_loop.field_config_from_args(args)
    jvars = j_loop.init_variables(jax.random.key(3), args, fcfg)
    for v in jvars.values():
        v["sigma"]["b"] = v["sigma"]["b"] + 0.5
    jopt = j_step.build_optimizer(jvars, lrate=args.lrate, lrate_decay=args.lrate_decay,
                                  lcfg=j_loop.loss_config_from_args(args))
    j_ckpt.save_checkpoint(os.path.join(bases["jax"], "logs", "exp"), STEP,
                           j_step.init_train_state(jvars, jopt), 0.0)
    tvars = field_params_from_numpy(jax.tree.map(np.asarray, jvars), "cpu")
    tstate = t_step.init_train_state(tvars, t_step.build_optimizer(tvars))
    ckpt_lib.save_checkpoint(os.path.join(bases["port"], "logs", "exp"), STEP, tstate, 0.0)
    return scene_dir, bases


def _pngs(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".png"))


def _assert_buffers(out, ref):
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert out[k].shape == r.shape, k
        atol, rtol = SHADED_TOL if k.startswith(SHADED) else BASIC_TOL
        np.testing.assert_allclose(out[k], r, atol=atol, rtol=rtol, err_msg=k)


MODES = {
    "plain": (),
    "edit": ("--edit_intrinsic", "--editing_img_idx", "1", "--edit_albedo", "--edit_roughness",
             "--edit_depth", *sum((["--editing_target_albedo_list", v] for v in
                                   ("0.9", "0.2", "0.1")), []),
             "--editing_target_roughness_list", "0.8"),
    "insert": ("--insert_object", "--inserting_img_idx", "1",
               *sum((["--inserting_target_albedo_list", v] for v in ("0.3", "0.6", "0.9")), []),
               "--inserting_target_roughness_list", "0.2",
               "--inserting_target_irradiance_list", "0.7"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_run_test_matches_jax(runs, mode):
    scene_dir, bases = runs
    out = test_cli.run_test(parse_with_includes(_argv(scene_dir, bases["port"], *MODES[mode])),
                            device="cpu")
    ref = j_test_cli.run_test(j_parse(_argv(scene_dir, bases["jax"], *MODES[mode])))
    _assert_buffers(out, ref)
    n_frames = 2 if mode == "plain" else 1
    assert out["rgb"].shape == (n_frames, 10, 13, 3)
    dirs = [os.path.join(bases[s], "logs_eval", "exp", f"testset_{STEP:06d}")
            for s in ("port", "jax")]
    assert _pngs(dirs[0]) == _pngs(dirs[1])
    assert f"rgb_{n_frames - 1:03d}.png" in _pngs(dirs[0])


def test_render_cli_matches_jax(runs):
    scene_dir, bases = runs
    extra = ("--orbit_frames", "3", "--orbit_radius", "3.5", "--trajectory", "orbit")
    out = render_cli.main(_argv(scene_dir, bases["port"], *extra), device="cpu")
    ref = j_render_cli.main(_argv(scene_dir, bases["jax"], *extra))
    _assert_buffers(out, ref)
    assert out["rgb"].shape == (3, 10, 13, 3)
    dirs = [os.path.join(bases[s], "logs", "exp", f"orbit_{STEP:06d}") for s in ("port", "jax")]
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1]))
    assert {"rgb.avi", "radiance.avi", "albedo.avi", "rgb_002.png"} <= set(names)
    for buf in ("rgb", "radiance", "albedo"):
        cap = cv2.VideoCapture(os.path.join(dirs[0], f"{buf}.avi"))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f[..., ::-1])
        np.testing.assert_array_equal(np.stack(frames),
                                      (np.clip(out[buf], 0, 1) * 255).astype(np.uint8))


def test_trainer_writes_a_video_on_i_video(runs, tmp_path):
    """The default schedule's video export: the test-set render at
    update 6 (a multiple of --i_video) writes video_000006.avi, whose
    frames are that render's rgb PNGs (both truncate to uint8)."""
    scene_dir, _ = runs
    argv = ["--datadir", scene_dir, "--basedir", str(tmp_path), "--expname", "exp",
            "--netdepth", "4", "--netwidth", "16", "--N_rand", "16", "--N_samples", "8",
            "--N_importance", "8", "--N_iter", "6", "--coarse_radiance_number", "2",
            "--load_depth_range_from_file", "--i_weights", "6", "--i_testset", "3",
            "--i_video", "6", "--render_factor", "4", "--testskip", "1"]
    loop.train(parse_with_includes(argv), device="cpu")
    logdir = tmp_path / "exp"
    assert sorted(p.name for p in logdir.glob("*.avi")) == ["video_000006.avi"]
    cap = cv2.VideoCapture(str(logdir / "video_000006.avi"))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    pngs = [cv2.imread(str(logdir / "testset_000006" / n))
            for n in sorted(n for n in _pngs(logdir / "testset_000006") if n.startswith("rgb_"))]
    assert len(frames) == len(pngs) == 2
    np.testing.assert_array_equal(np.stack(frames), np.stack(pngs))
    # the default schedule trains: no refusal of --i_video <= --N_iter
    loop.check_supported_flags(parse_with_includes(["--datadir", scene_dir]))
