"""Data parallelism over processes: two gloo processes on the CPU.

Two workers (this file run as a script, one process per rank, joined by
`parallel.distributed.initialize` over a free localhost port) take 3
updates of the global train step, each on its image shard's B/2 rays
with the global render and depth-volume draws (the volume rays, the
batch's first 12 of 16, span both ranks): their params are
bit-identical, and equal within 1e-6 to one process stepping on the
concatenated batch. `_slice_host_arrays` and `host_arrays_from_scene`
equal JAX's bit for bit. A 2-process `train()` writes its logdir from
rank 0 only, and its last checkpoint restores to the final params.
Every worker has its own timeout (300 s).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, N_VOL = 3, 16, 12
H, W, N_IMAGES = 12, 16, 4
LOSS = dict(infer_depth=True, n_iter_ignore_depth=0, n_iter_ignore_approximated_radiance=0,
            beta_inferred_depth=1.0)
TIMEOUT = 300

torch.set_num_threads(2)


def host_arrays(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    poses = np.stack([np.eye(4, dtype=np.float32)] * N_IMAGES)
    poses[:, 2, 3] = np.linspace(3, 4, N_IMAGES)
    poses[:, 0, 3] = np.linspace(-0.2, 0.2, N_IMAGES)
    arrays = {"images": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "prefiltered_images": rng.uniform(0, 1, (3, N_IMAGES, H, W, 3)),
              "normal": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "poses": poses,
              "K": np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]])}
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def build(pid: int, pcount: int):
    """(global step, state, samplers of ranks 0..pcount-1): the setup the
    workers and the single-process emulation share. Depth 8, width 32,
    8 + 8 samples, merged sampling, the inferred depth with its
    depth-volume pass."""
    from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
    from ibl_nerf_tpu_torch.models.aux_mlp import init_position_direction_mlp
    from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
    from ibl_nerf_tpu_torch.parallel import distributed
    from ibl_nerf_tpu_torch.render import RenderConfig
    from ibl_nerf_tpu_torch.train import losses, step

    fcfg = FieldConfig(depth=8, width=32, coarse_radiance_number=3, multires=4)
    rng = np.random.default_rng(1)
    variables = {"coarse": init_field_params(rng, fcfg, "cpu"),
                 "fine": init_field_params(rng, fcfg, "cpu"),
                 "depth_mlp": init_position_direction_mlp(rng, 8, 32, fcfg.input_ch,
                                                          fcfg.input_ch_views, 1, device="cpu")}
    for name in ("coarse", "fine"):
        variables[name]["sigma"]["b"] += 0.5
    variables["depth_mlp"]["out"]["b"] += 3.0
    rcfg = RenderConfig(field=fcfg, n_samples=8, n_importance=8, perturb=True,
                        normal_type="ground_truth", infer_depth=True,
                        correct_depth_for_prefiltered_radiance_infer=True)
    lcfg = losses.LossConfig(**LOSS)
    optimizer = step.build_optimizer(variables, lrate=5e-4, lrate_decay=500, lcfg=lcfg)
    state = step.init_train_state(variables, optimizer)
    gstep, place_state = distributed.make_global_train_step(
        rcfg, lcfg, losses.resolve_phase(100, lcfg), optimizer,
        {"brdf_lut": load_brdf_lut(device="cpu")}, B, 0.7, 2.0, 6.0,
        n_depth_random_volume=N_VOL, process_index=pid, process_count=pcount)
    samplers = [distributed.HostShardedSampler(host_arrays(), B, H, W, p, 2, merged=True,
                                               device="cpu") for p in range(2)]
    return gstep, place_state(state), samplers


def _draw_generator(i):
    return torch.Generator().manual_seed(1000 + i)


def _leaves(state):
    from ibl_nerf_tpu_torch.train.step import _leaves as leaves
    return [p.detach().clone() for p in leaves(state.variables)]


def worker_steps(rank: int, port: int, out: str) -> None:
    from ibl_nerf_tpu_torch.parallel import distributed

    assert distributed.initialize(f"localhost:{port}", 2, rank, device_type="cpu") == (rank, 2)
    gstep, state, samplers = build(rank, 2)
    losses = []
    for i in range(STEPS):
        draws = gstep.draw("cpu", _draw_generator(i))
        state, scalars = gstep(state, draws, *samplers[rank].sample(i))
        losses.append(float(scalars["loss_total"]))
    torch.save({"params": _leaves(state), "losses": losses, "step": state.step}, out)


def worker_train(rank: int, port: int, out: str, scene_dir: str, basedir: str) -> None:
    """A 2-process train(), recording every file this process opens for
    writing, every directory it makes and every checkpoint it saves."""
    import builtins

    from ibl_nerf_tpu_torch.cli.config import parse_with_includes
    from ibl_nerf_tpu_torch.parallel import distributed
    from ibl_nerf_tpu_torch.train import checkpoint, loop

    writes = []
    real_open, real_makedirs, real_write = builtins.open, os.makedirs, checkpoint._write

    def spy_open(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax+"):
            writes.append(str(file))
        return real_open(file, mode, *a, **kw)

    def spy_makedirs(name, *a, **kw):
        writes.append(str(name))
        return real_makedirs(name, *a, **kw)

    def spy_write(path, *a, **kw):
        writes.append(path)
        return real_write(path, *a, **kw)

    builtins.open, os.makedirs, checkpoint._write = spy_open, spy_makedirs, spy_write
    distributed.initialize(f"localhost:{port}", 2, rank, device_type="cpu")
    argv = ["--datadir", scene_dir, "--basedir", basedir, "--expname", "exp",
            "--netdepth", "4", "--netwidth", "16", "--N_rand", "16", "--N_samples", "8",
            "--N_importance", "8", "--N_iter", "3", "--coarse_radiance_number", "2",
            "--load_depth_range_from_file", "--N_iter_ignore_approximated_radiance", "2",
            "--i_weights", "3", "--i_testset", "3", "--summary_step", "1",
            "--render_factor", "4", "--testskip", "1", "--num_processes", "2"]
    state = loop.train(parse_with_includes(argv), device="cpu")
    builtins.open, os.makedirs, checkpoint._write = real_open, real_makedirs, real_write
    torch.save({"params": _leaves(state), "step": state.step,
                "writes": [w for w in writes if os.path.abspath(w).startswith(basedir)]}, out)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmp_path, mode, *extra) -> list[dict]:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    outs = [str(tmp_path / f"{mode}_{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               str(port), outs[r], *extra], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    return _run_workers(tmp_path_factory.mktemp("steps"), "steps")


def test_replicas_are_bit_identical(step_results):
    r0, r1 = step_results
    assert r0["step"] == r1["step"] == STEPS
    assert r0["losses"] == r1["losses"]
    for a, b in zip(r0["params"], r1["params"]):
        assert torch.equal(a, b)


def test_two_processes_equal_one_on_the_concatenated_batch(step_results):
    gstep, state, samplers = build(0, 1)
    assert gstep.n_vol == N_VOL and gstep.lo == 0 and gstep.hi == B
    start = _leaves(state)
    losses = []
    for i in range(STEPS):
        parts = [s.sample(i) for s in samplers]
        pixel_info = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
        batch = (pixel_info, torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts]))
        state, scalars = gstep(state, gstep.draw("cpu", _draw_generator(i)), *batch)
        losses.append(float(scalars["loss_total"]))
    r0 = step_results[0]
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-6)
    moved = 0.0
    for got, want, p0 in zip(r0["params"], _leaves(state), start):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
        moved = max(moved, float((want - p0).abs().max()))
    assert moved > 5e-4


def test_slice_host_arrays_matches_jax():
    from ibl_nerf_tpu.data.sampler import host_arrays_from_scene as j_host_arrays
    from ibl_nerf_tpu.parallel.distributed import _slice_host_arrays as j_slice
    from ibl_nerf_tpu_torch.data.sampler import host_arrays_from_scene
    from ibl_nerf_tpu_torch.parallel.distributed import _slice_host_arrays

    arrays = host_arrays()
    for pid in range(3):
        ours, theirs = _slice_host_arrays(arrays, pid, 3), j_slice(arrays, pid, 3)
        assert set(ours) == set(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)

    class Scene:
        images, poses = arrays["images"], arrays["poses"]
        prefiltered_images = arrays["prefiltered_images"]

        def focal_matrix(self):
            return arrays["K"]

        def gt_buffers(self):
            return {"normal": arrays["normal"]}

    ours = host_arrays_from_scene(Scene(), include=("normal", "depth"))
    theirs = j_host_arrays(Scene(), include=("normal", "depth"))
    assert set(ours) == set(theirs)
    for k in ours:
        assert isinstance(ours[k], np.ndarray)
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_two_process_train_writes_from_rank_zero(tmp_path):
    sys.path.insert(0, os.path.dirname(__file__))
    from make_synthetic_scene import make_scene
    from ibl_nerf_tpu_torch.train import checkpoint, step

    scene_dir = make_scene(str(tmp_path / "scene"))
    basedir = str(tmp_path / "logs")
    r0, r1 = _run_workers(tmp_path, "train", scene_dir, basedir)
    assert r0["step"] == r1["step"] == 4
    for a, b in zip(r0["params"], r1["params"]):
        assert torch.equal(a, b)
    assert r1["writes"] == []
    logdir = os.path.join(basedir, "exp")
    assert any(w.endswith("metrics.jsonl") for w in r0["writes"])
    assert sorted(d for d in os.listdir(logdir) if d.startswith("ckpt_")) == [
        "ckpt_000000", "ckpt_000003"]
    assert os.path.isdir(os.path.join(logdir, "testset_000003"))
    assert os.path.exists(os.path.join(logdir, "train_info_step_time.json"))
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "loss_total" in r] == [0, 1, 2, 3]
    restored, _, found = checkpoint.restore_checkpoint(logdir, _state_like(r0["params"]))
    assert found and restored.step == 4
    for a, b in zip(step._leaves(restored.variables), r0["params"]):
        assert torch.equal(a.detach(), b)


def _state_like(params):
    """A TrainState shaped like the 2-process train's (coarse and fine at
    depth 4, width 16), for restore_checkpoint."""
    from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
    from ibl_nerf_tpu_torch.train import step

    cfg = FieldConfig(depth=4, width=16, coarse_radiance_number=2)
    rng = np.random.default_rng(0)
    variables = {"coarse": init_field_params(rng, cfg, "cpu"),
                 "fine": init_field_params(rng, cfg, "cpu")}
    assert [p.shape for p in step._leaves(variables)] == [p.shape for p in params]
    return step.init_train_state(variables, step.build_optimizer(variables))


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, rank, port, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    if mode == "steps":
        worker_steps(rank, port, out)
    else:
        worker_train(rank, port, out, *sys.argv[5:])
