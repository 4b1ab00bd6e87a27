"""The Monte-Carlo estimator's spans (`utils/timing`): under the CPU
profiler a Monte-Carlo `render_rays` enters `render.mc_incident` and
`render.mc_brdf` once a shaded pass, each inside `render.shading`;
split-sum shading enters neither."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.utils import timing

torch.set_num_threads(2)

FIELD = FieldConfig(depth=8, width=16, coarse_radiance_number=3, multires=4)
MC_SPANS = ("render.mc_incident", "render.mc_brdf")


def _events(shading_mode: str, coarse_shading: bool) -> list:
    rng = np.random.default_rng(0)
    variables = {"coarse": init_field_params(rng, FIELD, "cpu"),
                 "fine": init_field_params(rng, FIELD, "cpu")}
    rcfg = RenderConfig(field=FIELD, n_samples=8, n_importance=8, perturb=False,
                        approximate_radiance=True, shading_mode=shading_mode,
                        mc_samples_axis=3, normal_type="normal_map_from_depth_gradient_epsilon",
                        coarse_shading=coarse_shading)
    g = torch.Generator().manual_seed(0)
    batch = make_ray_batch(torch.zeros(6, 3), torch.randn(6, 3, generator=g), 2.0, 6.0)
    consts = {"brdf_lut": load_brdf_lut(device="cpu")}
    with timing.spans_on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            render_rays(variables, consts, batch, rcfg)
    return [e for e in prof.events() if e.name in timing.SPANS]


@pytest.mark.parametrize("coarse_shading", [True, False], ids=["both_passes", "fast_path"])
@pytest.mark.parametrize("child", MC_SPANS)
def test_mc_spans_nest_in_shading(child, coarse_shading):
    events = _events("monte_carlo", coarse_shading)
    shading = [e.time_range for e in events if e.name == "render.shading"]
    kids = [e.time_range for e in events if e.name == child]
    assert len(kids) == len(shading) == (2 if coarse_shading else 1)
    assert all(any(s.start <= k.start and k.end <= s.end for s in shading) for k in kids)


def test_split_sum_enters_no_mc_span():
    names = {e.name for e in _events("split_sum", False)}
    assert "render.shading" in names and not names & set(MC_SPANS)
