"""The port's training CLI against the JAX package's.

The two parsers expose the same option strings with the same defaults.
A port `train` run on the CPU (N_iter 6 with the phase switch at 3,
`i_weights` 3, `i_testset` 6, the CLI's defaults otherwise: ground-truth
normals, merged sampling, bf16_grad) writes the same files as JAX's
`train` on the same scene and arguments: the checkpoint names, the keys
of train_info_step_time.json and of metrics.jsonl, and the test-set
PNG names. Every trainer flag of JAX's passes the check before anything
runs, float64 with use_pallas (refused until K1 had its f64 kernel)
trains, and the CLI refuses to run without a card.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ibl_nerf_tpu.cli.config import build_parser as j_build_parser
from ibl_nerf_tpu.cli.config import parse_with_includes as j_parse
from ibl_nerf_tpu.train.loop import train as j_train
from ibl_nerf_tpu_torch.cli import train as cli_train
from ibl_nerf_tpu_torch.cli.config import build_parser, parse_with_includes
from ibl_nerf_tpu_torch.train import loop
from ibl_nerf_tpu_torch.train.loop import train

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_scene import make_scene  # noqa: E402

torch.set_num_threads(2)


def _options(parser):
    return {opt: (a.dest, a.default, a.nargs, a.const, type(a).__name__)
            for a in parser._actions for opt in a.option_strings}


def test_parsers_expose_the_same_options_and_defaults():
    ours, theirs = _options(build_parser()), _options(j_build_parser())
    assert set(ours) == set(theirs)
    assert ours == theirs
    assert vars(parse_with_includes([])) == vars(j_parse([]))


def test_config_file_and_include_chain(tmp_path):
    (tmp_path / "base.txt").write_text("N_rand = 512\nN_importance = 128\nload_priors\n")
    (tmp_path / "scene.txt").write_text("include = base.txt\nN_rand = 1024\n"
                                        "editing_target_albedo_list = [0.1, 0.2]\n")
    argv = ["--config", str(tmp_path / "scene.txt"), "--N_samples", "32"]
    ours, theirs = parse_with_includes(argv), j_parse(argv)
    assert vars(ours) == vars(theirs)
    assert (ours.N_rand, ours.N_importance, ours.N_samples, ours.load_priors,
            ours.expname) == (1024, 128, 32, True, "scene")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene")))


def _argv(scene_dir, logdir, *extra):
    return ["--datadir", scene_dir, "--basedir", logdir, "--expname", "exp",
            "--netdepth", "4", "--netwidth", "16", "--N_rand", "16", "--N_samples", "8",
            "--N_importance", "8", "--N_iter", "6", "--coarse_radiance_number", "2",
            "--load_depth_range_from_file", "--N_iter_ignore_approximated_radiance", "3",
            "--i_weights", "3", "--i_testset", "6", "--summary_step", "2",
            "--render_factor", "4", "--testskip", "1", *extra]


def _files(logdir):
    ckpts = sorted(d for d in os.listdir(logdir) if d.startswith("ckpt_"))
    with open(os.path.join(logdir, "train_info_step_time.json")) as f:
        info = json.load(f)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    pngs = {d: sorted(os.listdir(os.path.join(logdir, d)))
            for d in os.listdir(logdir) if d.startswith("testset_")}
    return {"ckpts": ckpts, "info_keys": sorted(info),
            "metric_keys": sorted({k for r in records for k in r}),
            "metric_steps": [r["step"] for r in records], "pngs": pngs}, info


def test_train_writes_the_files_jax_writes(scene_dir, tmp_path):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    state = train(parse_with_includes(_argv(scene_dir, port_dir)), device="cpu")
    j_train(j_parse(_argv(scene_dir, jax_dir)))
    ours, info = _files(os.path.join(port_dir, "exp"))
    theirs, _ = _files(os.path.join(jax_dir, "exp"))
    assert ours == theirs
    assert ours["ckpts"] == ["ckpt_000000", "ckpt_000003", "ckpt_000006"]
    assert set(ours["pngs"]) == {"testset_000006"}
    assert "rgb_000.png" in ours["pngs"]["testset_000006"]
    assert state.step == info["global_step"] == 7


def test_unported_flags_are_refused_before_anything_runs(scene_dir, tmp_path):
    """The flags refused until their slices ported them (raw_noise_std,
    mesh_devices, num_processes, init_port_path, patch sampling) pass the
    check, as do the aux heads, the environment map, Monte-Carlo shading
    and the inferred normal; float64 with use_pallas, the renderer's last
    refusal until K1 had its f64 kernel, now trains (at depth 8, which K1
    takes) to its last checkpoint with finite losses."""
    logdir = str(tmp_path / "refused")
    for extra in (["--raw_noise_std", "1.0"], ["--mesh_devices", "2"],
                  ["--num_processes", "2"], ["--init_port_path", "x.tar"],
                  ["--ray_sample", "patch", "--no_batching"]):
        loop.check_supported_flags(parse_with_includes(_argv(scene_dir, logdir, *extra)))
    assert not os.path.exists(logdir)
    state = train(parse_with_includes(_argv(scene_dir, logdir, "--compute_dtype", "float64",
                                            "--use_pallas", "--netdepth", "8")), device="cpu")
    assert state.step == 7
    ours, _ = _files(os.path.join(logdir, "exp"))
    assert ours["ckpts"] == ["ckpt_000000", "ckpt_000003", "ckpt_000006"]
    with open(os.path.join(logdir, "exp", "metrics.jsonl")) as f:
        losses = [r["loss_total"] for r in map(json.loads, f) if "loss_total" in r]
    assert losses and np.isfinite(losses).all()
    loop.check_supported_flags(parse_with_includes(_argv(
        scene_dir, logdir, "--infer_normal", "--infer_normal_at_surface", "--infer_depth",
        "--infer_albedo_separate", "--infer_roughness_separate", "--infer_irradiance_separate",
        "--infer_visibility", "--use_environment_map", "--shading_mode", "monte_carlo",
        "--calculating_normal_type", "inferred_normal_map")))


def test_cli_needs_a_card(scene_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would train on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(_argv(scene_dir, str(tmp_path)))
    assert not os.path.exists(os.path.join(str(tmp_path), "exp"))
