"""The benchmark's Monte-Carlo cell on the CPU, at `benchmark/tests/tiny.py`'s
small size (float32, the kernels' plain versions):

- the cell `monte_carlo.render_test_f2` against `reference/monte_carlo.py`
  over three seeds, within `benchmark/tests/test_reference.py`'s float32
  tolerances, with every incident point counted;
- faults planted in the port's estimator (8 of the 9 directions marched,
  the weight 2π/M doubled, the directions left about +z), and
  `benchmark/faults.py`'s half of each chunk's rays, each making the
  cell's check fail; a program without the counter stops at set-up;
- the reference's directions and frame against the port's, and its
  imports (nothing of the port, of JAX or of the JAX package);
- `flops_mc`'s frame work against a count by hand, the reader of
  `device_ms.mc_incident.render`, and the port's counter
  `mc_incident_points` after one `render_rays`.
"""

import ast

import numpy as np
import pytest
import torch

from benchmark import faults, flops, flops_mc, harness
from benchmark.reference import monte_carlo as ref_mc
from benchmark.tests.tiny import execute, run_of
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.ops import geometry
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays, renderer

torch.set_num_threads(2)

CELL = "monte_carlo.render_test_f2"
# benchmark/tests/test_reference.py's: float32 sums in other orders
TOLERANCE = {"buffer_gap": 1e-4, "rgb_gap": 1e-4}


@pytest.mark.parametrize("seed", [2**33 + 5, 2**40 + 11, 12345])
def test_cell_matches_reference(seed):
    run, _ = run_of(CELL, seed)
    run.window(0.2)
    readings = run.check()
    assert readings["incident_points_gap"] == 0.0, readings
    assert all(readings[k] < tol for k, tol in TOLERANCE.items()), readings


_PORT_BRDF, _PORT_HEMISPHERE = renderer.microfacet_brdf, renderer._hemisphere


def _hemisphere_eight(n, device):
    return _PORT_HEMISPHERE(n, device)[:8]


def _doubled_weight(*args, **kwargs):
    glossy, diffuse, l_dot_n = _PORT_BRDF(*args, **kwargs)
    return glossy, diffuse, 2.0 * l_dot_n


FAULTS = {
    # the march over 8 of the 9 directions: the counter and the sums see it
    "eight_directions": ("_hemisphere", _hemisphere_eight, "incident_points_gap"),
    # 2π/M doubled (as the factor l·n both sums take)
    "weight_doubled": ("microfacet_brdf", _doubled_weight, "rgb_gap"),
    # the local directions marched about +z, not turned about the normal
    "directions_about_z": ("_world_directions",
                           lambda local, normal: local.expand(normal.shape[0], -1, -1),
                           "rgb_gap"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_estimator_fault_fails_the_check(fault, monkeypatch):
    name, patched, reading = FAULTS[fault]
    monkeypatch.setattr(renderer, name, patched)
    result = execute(CELL, 2**31 + 77)
    assert not result["correct"], result["checks"]
    c = result["checks"][reading]
    assert c["value"] > c["limit"], result["checks"]


def test_half_rays_fault_fails_the_check():
    undo = faults.RENDER["half_rays"]()
    try:
        result = execute(CELL, 2**31 + 78)
    finally:
        undo()
    assert not result["correct"]
    assert result["checks"]["incident_points_gap"]["value"] == pytest.approx(0.5)


def test_program_without_the_counter_stops_at_setup(monkeypatch):
    monkeypatch.delattr(renderer, "COUNTERS")
    with pytest.raises(RuntimeError, match="mc_incident_points"):
        run_of(CELL, 3)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_reference_directions_match_the_port(n):
    got = ref_mc.hemisphere_directions(n)
    want = torch.from_numpy(geometry.hemisphere_samples(n))
    torch.testing.assert_close(got, want, atol=2e-7, rtol=0)
    torch.testing.assert_close(got.norm(dim=-1), torch.ones(n * n), atol=1e-6, rtol=0)


def test_reference_frame_matches_the_port():
    g = torch.Generator().manual_seed(0)
    n = torch.randn(256, 3, generator=g)
    n = n / n.norm(dim=-1, keepdim=True)
    n = n[(n[:, 0] - n[:, 2]).abs() > 1e-3]       # off the frame's branch
    t, b = ref_mc.tangent_frame(n)
    b_port, t_port = geometry.get_tbn(n)
    torch.testing.assert_close(t, t_port, atol=1e-6, rtol=0)
    torch.testing.assert_close(b, b_port, atol=1e-6, rtol=0)


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse(open(ref_mc.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "math", "torch", "benchmark"}
    assert not names & {"jax", "jaxlib", "flax", "ibl_nerf_tpu", "ibl_nerf_tpu_torch"}


def test_frame_work_by_hand():
    args = {"netwidth": 256, "multires": 10, "multires_views": 4, "coarse_radiance_number": 3,
            "N_samples": 64, "N_importance": 128, "mc_samples_axis": 3,
            "compute_dtype": "bf16_grad"}
    rays = 76_800
    # density-only: trunk 63·256 + 4·256² + 319·256 + 2·256² = 491,008, σ 256
    density, full = 491_264, 491_008 + 304_768      # full: the heads, 304,768
    work = flops_mc.render_frame_work(args, rays, eps_normals=False)
    assert work == [("bf16", 2 * density * rays * 64), ("bf16", 2 * full * rays * 192),
                    ("f32", 2 * full * rays * 9 * 64)]
    # the incident marches alone: 70.4 TFLOP f32, 1.05 s at 67 TFLOP/s
    assert work[2][1] / 1e12 == pytest.approx(70.40, abs=0.01)
    assert flops.least_seconds(work) == pytest.approx(
        70.40e12 / 67e12 + (4.829e12 + 23.47e12) / 989e12, rel=1e-3)
    eps = flops_mc.render_frame_work(args, rays, eps_normals=True)
    assert eps[3] == ("f32", 2 * density * 4 * rays * 192)


def test_incident_reader():
    mod = harness.load_module(harness.BENCH / "metrics" / "device_ms.mc_incident.render.py")
    assert mod.read({}) is None
    assert mod.read({"spans": {"units": 2, "spans": {"render.shading": {}}}}) is None
    ctx = {"spans": {"units": 2, "spans": {"render.mc_incident": {"device_ms": [3.0, 5.0]}}}}
    assert mod.read(ctx) == 4.0


def test_counter_counts_every_incident_point():
    field = FieldConfig(depth=8, width=16, coarse_radiance_number=3, multires=4)
    rng = np.random.default_rng(0)
    variables = {"coarse": init_field_params(rng, field, "cpu"),
                 "fine": init_field_params(rng, field, "cpu")}
    rcfg = RenderConfig(field=field, n_samples=64, n_importance=8, perturb=False,
                        approximate_radiance=True, shading_mode="monte_carlo",
                        mc_samples_axis=3, normal_type="ground_truth", coarse_shading=False)
    b = 5
    g = torch.Generator().manual_seed(1)
    batch = make_ray_batch(torch.zeros(b, 3), torch.randn(b, 3, generator=g), 2.0, 6.0)
    gt = {"normal": torch.rand(b, 3, generator=g)}
    before = renderer.COUNTERS["mc_incident_points"]
    with torch.no_grad():
        render_rays(variables, {"brdf_lut": load_brdf_lut(device="cpu")}, batch, rcfg,
                    gt_values=gt)
    assert renderer.COUNTERS["mc_incident_points"] - before == b * 9 * 64
