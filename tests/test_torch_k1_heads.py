"""K1's head sets (`kernels/fused_field.HEAD_SETS`) on the CPU: a full query
returns only the raw columns its march reads, "reflected" (σ, the radiance
and the coarse heads) for the split-sum reflected march and "incident" (σ
and the radiance) for the Monte-Carlo incident march.

- the plain versions (f32, bf16 and f64 packs) and the CPU route of
  `fused_field_apply` return exactly the set's columns of the full output;
- `render_rays` under split-sum and Monte-Carlo shading, with K1
  (`use_pallas`) and on the eager query, returns every buffer bit-equal to
  the same call with every march on "all", and each march asks for its set;
- `LAUNCHES` holds the head sets' counters from import;
- `benchmark.trace.LaunchRecorder` records one K1 full call a march, with
  its points, through the renderer's positional head-set argument.
"""

import numpy as np
import pytest
import torch

from benchmark import trace
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.kernels import fused_field as tff
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays, renderer

torch.set_num_threads(2)

K = 3
CFG = FieldConfig(depth=8, width=32, coarse_radiance_number=K)
B, S, I, MC_AXIS = 6, 8, 8, 2
SHADING = {
    "split_sum": dict(normal_type="ground_truth"),
    "monte_carlo": dict(normal_type="ground_truth", shading_mode="monte_carlo"),
}
MARCH_HEADS = {"split_sum": "reflected", "monte_carlo": "incident"}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    variables = {"coarse": init_field_params(rng, CFG, "cpu"),
                 "fine": init_field_params(rng, CFG, "cpu")}
    for v in variables.values():   # visible density
        v["sigma"]["b"] += 0.5
    gen = torch.Generator().manual_seed(7)
    rays_o = torch.randn((B, 3), generator=gen) * 0.1 + torch.tensor([0.0, 0.0, 4.0])
    rays_d = torch.nn.functional.normalize(
        torch.randn((B, 3), generator=gen) * 0.2 + torch.tensor([0.0, 0.0, -1.0]), dim=-1)
    normal = torch.nn.functional.normalize(torch.randn((B, 3), generator=gen), dim=-1)
    gt = {"normal": 0.5 * (normal + 1.0), "albedo": torch.rand((B, 3), generator=gen)}
    return {"variables": variables, "consts": {"brdf_lut": load_brdf_lut(device="cpu")},
            "batch": make_ray_batch(rays_o, rays_d, 2.0, 6.0), "gt": gt}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("heads", list(tff.HEAD_SETS))
def test_plain_returns_the_sets_columns(heads, dtype):
    params = init_field_params(np.random.default_rng(3), CFG, "cpu")
    packed = tff.pack_field_weights(params, CFG, dtype=dtype)
    gen = torch.Generator().manual_seed(4)
    pts = torch.rand((5, 7, 3), generator=gen) * 4 - 2
    dirs = torch.nn.functional.normalize(torch.randn((5, 3), generator=gen), dim=-1)
    full = tff.fused_field_apply_plain(packed, pts, dirs, CFG)
    cols = tff.head_columns(heads, K)
    want = full[..., cols]
    assert full.shape[-1] == 9 + 3 * K
    assert torch.equal(tff.fused_field_apply_plain(packed, pts, dirs, CFG, heads), want)
    before = dict(tff.LAUNCHES)
    assert torch.equal(tff.fused_field_apply(packed, pts, dirs, CFG, heads), want)
    assert tff.LAUNCHES == before   # the plain version is no launch
    # σ first, then the radiance at `radiance_column`, then the coarse heads
    rad = tff.radiance_column(heads)
    assert cols[0] == 0 and cols[rad:rad + 3] == [6, 7, 8]
    assert cols[rad + 3:] == ([] if heads == "incident" else list(range(9, 9 + 3 * K)))


def test_launches_hold_the_head_sets_from_import():
    for heads in ("incident", "reflected"):
        assert isinstance(tff.LAUNCHES[f"fused_field_apply_{heads}"], int)
    with pytest.raises(ValueError, match="head set"):
        tff.fused_field_apply(tff.pack_field_weights(
            init_field_params(np.random.default_rng(0), CFG, "cpu"), CFG),
            torch.zeros((1, 1, 3)), torch.zeros((1, 3)), CFG, "albedo")


def _rcfg(shading: str, use_pallas: bool) -> RenderConfig:
    return RenderConfig(field=CFG, n_samples=S, n_importance=I, perturb=False,
                        approximate_radiance=True, coarse_shading=False,
                        correct_depth_for_prefiltered_radiance_infer=True,
                        mc_samples_axis=MC_AXIS, compute_dtype="float32",
                        use_pallas=use_pallas, **SHADING[shading])


def _render(scene, rcfg):
    with torch.no_grad():
        return render_rays(scene["variables"], scene["consts"], scene["batch"], rcfg,
                           gt_values=scene["gt"])


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("shading", list(SHADING))
def test_render_rays_equals_every_march_on_all(scene, shading, use_pallas, monkeypatch):
    rcfg = _rcfg(shading, use_pallas)
    asked = []
    full_ng, composite = renderer.FieldQueries.full_ng, renderer._composite_radiance_stack

    def recording_full_ng(self, pts, viewdirs, heads="all"):
        asked.append(heads)
        return full_ng(self, pts, viewdirs, heads)

    monkeypatch.setattr(renderer.FieldQueries, "full_ng", recording_full_ng)
    out = _render(scene, rcfg)
    assert asked == [MARCH_HEADS[shading]]

    monkeypatch.setattr(renderer.FieldQueries, "full_ng",
                        lambda self, pts, viewdirs, heads="all": full_ng(self, pts, viewdirs))
    monkeypatch.setattr(renderer, "_composite_radiance_stack",
                        lambda raw, z, d, rc, heads="all": composite(raw, z, d, rc))
    ref = _render(scene, rcfg)
    assert out.keys() == ref.keys()
    assert "color_map" in out and torch.isfinite(out["color_map"]).all()
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("shading", list(SHADING))
def test_launch_recorder_records_a_k1_call_a_march(scene, shading):
    """The fine pass's march on K1 full, one call of its points: B·M·S
    under Monte-Carlo shading, B·S for the reflected march; nothing on
    K1 density (gt normals) or K2 (no use_pallas_train)."""
    rec = trace.LaunchRecorder(renderer)
    try:
        out = _render(scene, _rcfg(shading, True))
    finally:
        calls = rec.close()
    assert torch.isfinite(out["color_map"]).all()
    points = B * MC_AXIS ** 2 * S if shading == "monte_carlo" else B * S
    assert calls == {"k2": [], "k3": [], "k1_full": [points], "k1_density": []}
