"""Training with ε-normals (`normal_map_from_depth_gradient_epsilon`, as
IBL-NeRF's own configurations train) and the benchmark's cell
`eps_normals.train4096`, on the CPU at `benchmark/tests/tiny.py`'s small
size (the kernels' plain versions):

- the port's train step against `benchmark/reference/eps_normals.py` on
  seeded weights and the same draws, its fine passes held on the port's
  importance samples, over 2 updates: the loss, the first gradients, each
  leaf's change, each pass's normals and the samples, at float32 and at
  the port's default bf16_grad on K1/K2/K3;
- the counter `eps_normal_points`: 4·B·S points for each shaded pass's
  sweep, under both ε estimators, batched or offset by offset, and none
  under gt normals;
- the sweep in a training update: one K1 density query a pass, on the
  pass's one pack, and no eager density query;
- the cell: a sound run is correct; one offset of the four dropped, ε
  doubled, gt normals in place of the sweep, importance samples at fixed
  quantiles, and `benchmark/faults.py`'s training faults each make it
  fail; a program without the counter stops
  at set-up;
- the reference's estimator against the port's, its imports, `flops_eps`'s
  update work, the cell's normal gaps and the reader of
  `device_ms.normal.train`.
"""

import ast
import time

import numpy as np
import pytest
import torch

from benchmark import faults, faults_eps, flops, flops_eps, harness, trace
from benchmark.reference import eps_normals as ref_eps
from benchmark.reference import nerf
from benchmark.tests import tiny
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, normals, render_rays, renderer

torch.set_num_threads(2)

CELL = "eps_normals.train4096"
KERNELS = dict(compute_dtype="bf16_grad", use_pallas=True, use_pallas_train=True)
MODES = {"float32": {}, "bf16_grad": KERNELS}
COUNTER = "eps_normal_points"


def run_eps(seed: int, updates: int = 3, **args):
    """The cell's traffic run on the CPU at the small size, `updates` checked."""
    wl = harness.read_json(harness.BENCH / "workloads" / f"{CELL}.json")
    cfg = harness.read_json(harness.BENCH / "configs" / f"{wl['config']}.json")
    config = dict(cfg, args={**cfg["args"], **tiny.ARGS, **args},
                  scene={**cfg["scene"], **tiny.SCENE})
    kind = harness.load_module(harness.BENCH / "traffic" / f"{wl['traffic']['kind']}.py")
    traffic = {**wl["traffic"], **tiny.TRAFFIC, "checked_updates": updates,
               "warmup_updates": max(updates, tiny.TRAFFIC["warmup_updates"])}
    return kind.Run(config, traffic, seed, torch.device("cpu"),
                      harness.Phases(time.perf_counter()))


# With the fine pass held on the port's samples, the normals and samples
# agree to rounding: 0 at float32, under 1.1e-5 on the bf16 path (the
# control, one step below, from 8.4e-4). The first gradients agree to
# 5e-6 at float32 and 1.6e-3 on the bf16 path (the control from 0.06).
# Adam's first steps are about lr in every element whatever the gradient's
# size, so an element whose gradient is nought to rounding moves by lr on
# one side and not the other, and the ε-normal reads the moved density 50
# times larger: the second update's loss and the worst leaf's change keep
# some of that (seed 7: loss 4.1e-4 at float32, 9.1e-4 on the bf16 path).
# The faults read at least 0.5 (normal_gap) or 1.1 (sample_gap).
TOLERANCE = {
    "float32": {"loss": 2e-3, "first_grad": 1e-4, "first_grad_median": 1e-6,
                "change": 1e-2, "change_median": 1e-4, "normal_gap": 1e-5,
                "normal_gap_fine": 1e-5, "sample_gap": 1e-5},
    "bf16_grad": {"loss": 3e-3, "first_grad": 1e-2, "first_grad_median": 3e-4,
                  "change": 6e-2, "change_median": 1.5e-3, "normal_gap": 1e-4,
                  "normal_gap_fine": 1e-4, "sample_gap": 1e-4},
}


@pytest.mark.parametrize("seed", [2**33 + 5, 7, 31337])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_training_matches_reference(mode, seed):
    run = run_eps(seed, updates=2, N_rand=256, **MODES[mode])
    readings = run.check()
    assert readings["eps_points_gap"] == 0.0
    assert all(readings[k] < tol for k, tol in TOLERANCE[mode].items()), readings


def _render(normal_type: str, n_importance: int, **kw) -> int:
    """The counter's growth over one shaded render_rays of 5 rays x 16
    samples (+ n_importance), both passes shaded as in training."""
    field = FieldConfig(depth=8, width=16, coarse_radiance_number=3, multires=4)
    rng = np.random.default_rng(0)
    variables = {"coarse": init_field_params(rng, field, "cpu"),
                 "fine": init_field_params(rng, field, "cpu")}
    rcfg = RenderConfig(field=field, n_samples=16, n_importance=n_importance, perturb=False,
                        approximate_radiance=True, normal_type=normal_type,
                        coarse_shading=True, **kw)
    g = torch.Generator().manual_seed(1)
    batch = make_ray_batch(torch.zeros(5, 3), torch.randn(5, 3, generator=g), 2.0, 6.0)
    gt = {"normal": torch.rand(5, 3, generator=g)}
    before = renderer.COUNTERS[COUNTER]
    with torch.no_grad():
        render_rays(variables, {"brdf_lut": load_brdf_lut(device="cpu")}, batch, rcfg,
                    gt_values=gt)
    return renderer.COUNTERS[COUNTER] - before


@pytest.mark.parametrize("normal_type,scan", [
    ("normal_map_from_depth_gradient_epsilon", False),
    ("normal_map_from_depth_gradient_epsilon", True),
    ("normal_map_from_depth_gradient_direction_epsilon", False)])
def test_counter_counts_each_pass(normal_type, scan):
    assert _render(normal_type, 0, sweep_scan=scan) == 4 * 5 * 16
    assert _render(normal_type, 8, sweep_scan=scan) == 4 * 5 * 16 + 4 * 5 * (16 + 8)


def test_counter_counts_nothing_under_gt_normals():
    assert _render("ground_truth", 8) == 0


def test_sweep_runs_on_k1_once_a_pass(monkeypatch):
    """One update on the card's path: K2/K3 and the reflected march as
    under gt normals, one K1 density query of 4·B·S points a pass, K1's
    weights the pass's one (K2's) pack, and no eager density query."""
    run = run_eps(2**33 + 5, **KERNELS)
    packs, eager = [], []
    pack, density = renderer.pack_field_weights, renderer.apply_field_density
    monkeypatch.setattr(renderer, "pack_field_weights",
                        lambda *a, **k: packs.append(1) or pack(*a, **k))
    monkeypatch.setattr(renderer, "apply_field_density",
                        lambda *a, **k: eager.append(1) or density(*a, **k))
    rec = trace.LaunchRecorder(renderer)
    try:
        run.one()
    finally:
        calls = rec.close()
    b, s, i = run.args["N_rand"], run.args["N_samples"], run.args["N_importance"]
    assert calls == {"k2": [b * s, b * (s + i)], "k3": [b * s, b * (s + i)],
                     "k1_full": [b * s, b * s], "k1_density": [4 * b * s, 4 * b * (s + i)]}
    assert packs == [1, 1] and eager == []


def test_sound_run_is_correct():
    result = tiny.execute(CELL, 2**31 + 99)
    assert result["correct"], result["checks"]
    assert result["checks"]["eps_points_gap"]["value"] == 0.0
    assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}


# each fault and a reading that fails it (besides `correct`)
FAULTS = {"one_offset_dropped": "normal_gap", "eps_doubled": "normal_gap",
          "gt_normals": "normal_gap", "samples_fixed": "sample_gap",
          "state_unchanged": "change_median", "half_batch": "eps_points_gap"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails_the_check(fault):
    undo = {**faults_eps.EPS, **faults.TRAIN}[fault]()
    try:
        result = tiny.execute(CELL, 2**31 + 77)
    finally:
        undo()
    assert not result["correct"], result["checks"]
    c = result["checks"][FAULTS[fault]]
    assert c["value"] > c["limit"], result["checks"]


def test_program_without_the_counter_stops_at_setup(monkeypatch):
    monkeypatch.setattr(renderer, "COUNTERS", {"mc_incident_points": 0})
    with pytest.raises(RuntimeError, match=COUNTER):
        tiny.run_of(CELL, 3)


def test_reference_refuses_what_it_does_not_model():
    args = harness.read_json(harness.BENCH / "configs" / "eps_normals.json")["args"]
    ref_eps.check_supported(args)
    for bad in ({"calculating_normal_type": "ground_truth"}, {"infer_depth": True}):
        with pytest.raises(NotImplementedError):
            ref_eps.check_supported({**args, **bad})


def test_reference_estimator_is_the_ports():
    """`nerf.eps_normals` and the port's estimator on one density: the same
    offsets, depths and cross product."""
    g = torch.Generator().manual_seed(4)
    rays_o = torch.randn(32, 3, generator=g)
    rays_d = torch.randn(32, 3, generator=g)
    z = torch.sort(2.0 + 4.0 * torch.rand(32, 24, generator=g), dim=-1).values
    w = torch.randn(3, 16, generator=g)

    def sigma(p):
        return torch.sin(p @ w).sum(-1)

    want = normals.normal_from_depth_gradient_epsilon(
        lambda p: sigma(p)[..., None], rays_o, rays_d, z, 0.01, scan=True)
    got = nerf.eps_normals(sigma, rays_o, rays_d, z, 0.01)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse(open(ref_eps.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "torch", "benchmark"}


@pytest.mark.parametrize("n_rand", [4096, 512])
def test_update_work_counts_the_sweep(n_rand):
    args = harness.read_json(harness.BENCH / "configs" / "eps_normals.json")["args"]
    work = flops_eps.train_update_work(args, n_rand)
    base = flops.train_update_work(args, n_rand)
    points = flops_eps.sweep_points(args, n_rand)
    assert points == 4 * n_rand * 256
    # density only at f32 weights: trunk 491,008 multiply-adds a point and σ's 256
    assert work == base + [("f32", 2 * 491_264 * points)]
    # at 4096 rays ~61.5 ms of sweep at 67 TFLOP/s beside the update's other queries
    assert flops.least_seconds(work) - flops.least_seconds(base) == pytest.approx(
        61.51e-3 * n_rand / 4096, abs=0.01e-3)


def test_normal_reader():
    mod = harness.load_module(harness.BENCH / "metrics" / "device_ms.normal.train.py")
    assert mod.read({}) is None
    assert mod.read({"spans": {"units": 3, "spans": {"render.fine": {}}}}) is None
    ctx = {"spans": {"units": 3, "spans": {"render.normal": {"device_ms": [90.0, 91.0, 92.0]}}}}
    assert mod.read(ctx) == 91.0


def test_normal_gaps_are_each_pass_median_ray():
    from benchmark.traffic.train_updates_eps import normal_gaps

    ref = [torch.zeros(5, 3), torch.zeros(5, 3)]
    prog = [torch.zeros(5, 3), torch.zeros(5, 3)]
    prog[0][:2, 0] = 1.0                   # two rays of five: the median ray agrees
    prog[1][:3, 0] = 0.5
    assert normal_gaps(prog, ref) == {"normal_gap": 0.0, "normal_gap_fine": 0.5}
    inf = float("inf")
    assert normal_gaps(prog[:1], ref) == {"normal_gap": inf, "normal_gap_fine": inf}
    assert normal_gaps([prog[0], prog[1][:4]], ref) == {"normal_gap": 0.0,
                                                        "normal_gap_fine": inf}
