"""The port's spans (`utils/timing.span`): off by default and then the
shared null context, on under `spans_on` (nesting, restoring) and
`profile_trace`, every name declared in `SPANS` and none a kernel symbol
the benchmark's rooflines match; under the CPU profiler a train step
(with and without the aux heads and the depth-volume pass) and a
`render_path` frame open them nested as the layers nest."""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.readers import KERNELS
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.eval.render_path import render_path
from ibl_nerf_tpu_torch.models.aux_mlp import init_position_direction_mlp, init_position_mlp
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.train import losses, step
from ibl_nerf_tpu_torch.utils import timing

torch.set_num_threads(2)

PORT = pathlib.Path(__file__).resolve().parent.parent / "ibl_nerf_tpu_torch"
H, W, N_IMAGES, B, N_VOL = 12, 16, 3, 16, 8
NEAR, FAR = 2.0, 6.0
FIELD = FieldConfig(depth=8, width=16, coarse_radiance_number=3, multires=4)
EPS = "normal_map_from_depth_gradient_epsilon"
AUX = dict(infer_normal=True, infer_depth=True, infer_albedo_separate=True)
AUX_LOSS = dict(infer_normal=True, infer_depth=True, n_iter_ignore_normal=0,
                n_iter_ignore_depth=0, n_iter_ignore_approximated_radiance=0)


def _arrays():
    rng = np.random.default_rng(0)
    poses = np.stack([np.eye(4, dtype=np.float32)] * N_IMAGES)
    poses[:, 2, 3] = np.linspace(3, 4, N_IMAGES)
    arrays = {"images": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "prefiltered_images": rng.uniform(0, 1, (3, N_IMAGES, H, W, 3)),
              "normal": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "poses": poses,
              "K": np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]])}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in arrays.items()}


def _variables(aux: bool) -> dict:
    rng = np.random.default_rng(1)
    variables = {"coarse": init_field_params(rng, FIELD, "cpu"),
                 "fine": init_field_params(rng, FIELD, "cpu")}
    if aux:
        w, in_ch = FIELD.width, FIELD.input_ch
        variables["depth_mlp"] = init_position_direction_mlp(
            rng, 8, w, in_ch, FIELD.input_ch_views, 1, device="cpu")
        for name in ("normal_mlp", "albedo_mlp"):
            variables[name] = init_position_mlp(rng, 8, w, in_ch, 3, device="cpu")
    return variables


def _rcfg(**kw) -> RenderConfig:
    return RenderConfig(field=FIELD, n_samples=4, n_importance=4, perturb=True,
                        approximate_radiance=True, normal_type=EPS, **kw)


def _train_step(aux: bool):
    """A tiny CPU train step and its state; the aux variant runs the aux
    heads and, from gt normals, the depth-volume pass."""
    lcfg = losses.LossConfig(**(AUX_LOSS if aux else {}))
    phase = losses.resolve_phase(100 if aux else 50000, lcfg)
    variables = _variables(aux)
    opt = step.build_optimizer(variables, lcfg=lcfg)
    fn = step.make_train_step(_rcfg(**(AUX if aux else {})), lcfg, phase, opt,
                              {"brdf_lut": load_brdf_lut(device="cpu")}, H, W, B, 0.7,
                              NEAR, FAR, merged_sampling=True, n_depth_random_volume=N_VOL)
    return fn, step.init_train_state(variables, opt, step=7)


def _profiled(fn) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name in timing.SPANS]


def _inside(events, child: str, *parents: str) -> bool:
    """Every `child` range lies in a range of one of `parents`, and one ran."""
    kids = [e.time_range for e in events if e.name == child]
    outer = [e.time_range for e in events if e.name in parents]
    return bool(kids) and all(any(o.start <= k.start and k.end <= o.end for o in outer)
                              for k in kids)


class _Scene:
    height, width, focal, near, far = H, W, 20.0, NEAR, FAR
    poses = _arrays()["poses"][:2].numpy()

    def gt_buffers(self):
        return {}


def test_span_is_the_shared_null_context_when_off():
    assert timing.span("train.update") is timing.span("render.fine", unit=3)
    assert timing.span("no.such.span") is timing.span("kernel.k1")
    fn, state = _train_step(aux=False)
    gen = torch.Generator().manual_seed(0)
    assert _profiled(lambda: fn(state, _arrays(), generator=gen)) == []


def test_spans_on_nests_and_restores():
    assert timing.span("train.update") is timing.span("render.fine")
    with timing.spans_on():
        with timing.spans_on():
            assert isinstance(timing.span("train.update", unit=1),
                              torch.autograd.profiler.record_function)
        assert timing.span("train.update") is not timing.span("train.update")
    assert timing.span("train.update") is timing.span("render.fine")
    with pytest.raises(RuntimeError, match="inside"):
        with timing.spans_on():
            raise RuntimeError("inside")
    assert timing.span("train.update") is timing.span("render.fine")


def test_unknown_span_raises_when_on():
    with timing.spans_on():
        with pytest.raises(ValueError, match="no.such.span"):
            timing.span("no.such.span")
        with timing.span("render.normal"):
            pass


@pytest.mark.parametrize("aux", [False, True], ids=["split_sum", "aux_heads"])
def test_train_step_spans_nest(aux):
    fn, state = _train_step(aux)
    gen = torch.Generator().manual_seed(0)
    with timing.spans_on():
        events = _profiled(lambda: fn(state, _arrays(), generator=gen))
    assert [e.name for e in events].count("train.update") == 1 and state.step == 8
    for child in ("train.forward", "train.backward", "train.optimizer"):
        assert _inside(events, child, "train.update"), child
    for child in ("render.coarse", "render.importance", "render.fine"):
        assert _inside(events, child, "train.forward"), child
    for child in ("render.normal", "render.shading", "render.aux_heads"):
        assert _inside(events, child, "render.coarse", "render.fine"), child
    names = {e.name for e in events}
    assert ("render.depth_head" in names) == aux
    assert ("train.depth_volume" in names) == aux
    if aux:
        assert _inside(events, "train.depth_volume", "train.forward")
        assert _inside(events, "render.depth_head", "train.forward")
    assert not names & {"kernel.k1", "kernel.k2", "kernel.k3"}   # no kernel on the CPU


def test_render_path_spans_nest():
    lut = load_brdf_lut(device="cpu")
    rcfg = _rcfg().replace(perturb=False)
    with timing.spans_on():
        events = _profiled(lambda: render_path(_variables(False), {"brdf_lut": lut}, _Scene(),
                                               rcfg, chunk=64, fast=True))
    assert [e.name for e in events].count("render_path.frame") == 2
    for child in ("render_path.setup", "render_path.chunks", "render_path.export"):
        assert _inside(events, child, "render_path.frame"), child
    for child in ("render.coarse", "render.fine", "render.normal", "render.shading"):
        assert _inside(events, child, "render_path.chunks"), child


def test_profile_trace_records_the_spans(tmp_path):
    batch = make_ray_batch(torch.zeros(4, 3), torch.tensor([[0.0, 0.0, 1.0]] * 4), NEAR, FAR)
    with timing.profile_trace(str(tmp_path), device="cpu"):
        with torch.no_grad():
            render_rays(_variables(False), {"brdf_lut": load_brdf_lut(device="cpu")}, batch,
                        _rcfg().replace(perturb=False))
    text = (tmp_path / timing.TRACE_NAME).read_text()
    assert '"render.coarse"' in text and '"render.shading"' in text
    assert timing.span("render.coarse") is timing.span("render.fine")


def _entered() -> set[str]:
    """The first argument of every `span(...)` call in the port."""
    names = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span"
                    and node.args):
                assert isinstance(node.args[0], ast.Constant), (path, node.lineno)
                names.add(node.args[0].value)
    return names


def test_every_span_entered_is_declared():
    assert _entered() == set(timing.SPANS)
    assert len(set(timing.SPANS)) == len(timing.SPANS)


def test_no_span_matches_a_kernel_symbol():
    for name in timing.SPANS:
        assert re.fullmatch(r"[a-z_]+\.[a-z_0-9]+", name), name
        for pattern, _, _ in KERNELS.values():
            assert not re.search(pattern, name), (name, pattern)
