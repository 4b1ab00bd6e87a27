"""Checkpoints of the port's trainer: the JAX package's directory naming
(`ckpt_{step:06d}`) and restore order (ft_path, then target_step, then
the newest), a bit-exact round trip of params, named Adam state, step
and elapsed time, and a resumed run that starts at the first update its
checkpoint lacks and ends bit for bit where an uninterrupted run ends.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ibl_nerf_tpu_torch.cli.config import parse_with_includes
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.train import checkpoint as ckpt
from ibl_nerf_tpu_torch.train.loop import train
from ibl_nerf_tpu_torch.train.step import _leaves, build_optimizer, init_train_state

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_scene import make_scene  # noqa: E402

torch.set_num_threads(2)


def _state(seed=0, steps=0):
    cfg = FieldConfig(depth=4, width=16, coarse_radiance_number=2)
    rng = np.random.default_rng(seed)
    variables = {"coarse": init_field_params(rng, cfg, "cpu"),
                 "fine": init_field_params(rng, cfg, "cpu")}
    opt = build_optimizer(variables)
    state = init_train_state(variables, opt)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):  # moments and counts that are not zero
        grads = {k: [torch.randn(p.shape, generator=gen) for p in _leaves(v)]
                 for k, v in state.variables.items()}
        with torch.no_grad():
            for name, o in opt.groups.items():
                o.update_(_leaves(state.variables[name]), grads[name], state.opt_state[name])
        state.step += 1
    return state


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(_leaves(a.variables), _leaves(b.variables)):
        assert torch.equal(x.detach(), y.detach())
    assert set(a.opt_state) == set(b.opt_state)
    for name in a.opt_state:
        sa, sb = a.opt_state[name], b.opt_state[name]
        assert (sa.count, sa.seen) == (sb.count, sb.seen)
        for x, y in zip(sa.mu + sa.nu, sb.mu + sb.nu):
            assert torch.equal(x, y)


def test_round_trip_is_bit_exact(tmp_path):
    state = _state(steps=3)
    path = ckpt.save_checkpoint(str(tmp_path), 2, state, 12.5)
    assert os.path.basename(path) == "ckpt_000002"
    assert sorted(os.listdir(path)) == [ckpt.STATE_FILE]
    restored, elapsed, found = ckpt.restore_checkpoint(str(tmp_path), _state(seed=1))
    assert found and elapsed == 12.5
    _assert_states_equal(restored, state)
    assert all(p.requires_grad for p in _leaves(restored.variables))


def test_restore_order(tmp_path):
    """Newest by default; target_step picks its own; ft_path wins over
    both; a missing target or an empty logdir leaves the state as it is."""
    states = {s: _state(seed=s, steps=s) for s in (1, 2, 3)}
    for s, st in states.items():
        ckpt.save_checkpoint(str(tmp_path / "logs"), s * 10, st, float(s))
    assert [s for s, _ in ckpt.list_checkpoints(str(tmp_path / "logs"))] == [10, 20, 30]
    template = _state(seed=9)
    newest, elapsed, found = ckpt.restore_checkpoint(str(tmp_path / "logs"), template)
    assert found and elapsed == 3.0
    _assert_states_equal(newest, states[3])
    target, _, _ = ckpt.restore_checkpoint(str(tmp_path / "logs"), template, target_step=20)
    _assert_states_equal(target, states[2])
    ft, _, _ = ckpt.restore_checkpoint(str(tmp_path / "logs"), template, target_step=20,
                                       ft_path=str(tmp_path / "logs" / "ckpt_000010"))
    _assert_states_equal(ft, states[1])
    for kw in (dict(target_step=40), dict(ft_path=str(tmp_path / "nowhere"))):
        same, elapsed, found = ckpt.restore_checkpoint(str(tmp_path / "logs"), template, **kw)
        assert same is template and not found and elapsed == 0.0
    same, _, found = ckpt.restore_checkpoint(str(tmp_path / "empty"), template)
    assert same is template and not found


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene")))


def _args(scene_dir, logdir, n_iter):
    return parse_with_includes([
        "--datadir", scene_dir, "--basedir", logdir, "--expname", "exp",
        "--netdepth", "4", "--netwidth", "16", "--N_rand", "16", "--N_samples", "8",
        "--N_importance", "8", "--N_iter", str(n_iter), "--coarse_radiance_number", "2",
        "--load_depth_range_from_file", "--N_iter_ignore_approximated_radiance", "3",
        "--i_weights", "2", "--i_testset", "100000", "--summary_step", "1"])


def test_resume_starts_at_the_first_missing_update(scene_dir, tmp_path):
    """N_iter 4 writes ckpt_000004 after update 4 (5 updates done); a run
    to N_iter 6 from it takes updates 5 and 6 only and ends where one
    uninterrupted run to 6 ends, bit for bit."""
    straight = train(_args(scene_dir, str(tmp_path / "a"), 6), device="cpu")
    train(_args(scene_dir, str(tmp_path / "b"), 4), device="cpu")
    logdir = str(tmp_path / "b" / "exp")
    assert [s for s, _ in ckpt.list_checkpoints(logdir)] == [0, 2, 4]
    resumed = train(_args(scene_dir, str(tmp_path / "b"), 6), device="cpu")
    assert straight.step == resumed.step == 7
    _assert_states_equal(resumed, straight)
    steps = [json.loads(line)["step"] for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert steps == [0, 1, 2, 3, 4, 5, 6]
    with open(os.path.join(logdir, "train_info_step_time.json")) as f:
        assert json.load(f)["global_step"] == 7
