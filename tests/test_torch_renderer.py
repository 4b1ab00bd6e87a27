"""The port's inference slice against the JAX renderer.

`render_rays` (coarse pass -> deterministic sample_pdf -> fine pass with
ε-normals, the BRDF-LUT fetch, the reflected march and mip_interp) and
`render_path` run on both sides with the same weights (JAX init through
`field_params_from_numpy`), the same rays and the real LUT. Depth 8,
width 32, 8 rays, 8+8 samples. Tolerances follow
tests/test_renderer_parity.py: atol 5e-4 / rtol 1e-3 on the basic maps,
atol 2e-3 / rtol 5e-3 on the shaded maps.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_load_lut
from ibl_nerf_tpu.eval.render_path import render_path as j_render_path
from ibl_nerf_tpu.models.field import FieldConfig as JFieldConfig
from ibl_nerf_tpu.models.field import init_field_params as j_init
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.render import make_ray_batch as j_batch
from ibl_nerf_tpu.render import render_image as j_render_image
from ibl_nerf_tpu.render import render_rays as j_render_rays
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.eval.render_path import render_path
from ibl_nerf_tpu_torch.models.aux_mlp import init_position_direction_mlp, init_position_mlp
from ibl_nerf_tpu_torch.models.field import FieldConfig
from ibl_nerf_tpu_torch.render import (RenderConfig, make_frame_render_fn,
                                       make_ray_batch, render_frame,
                                       render_image, render_rays)
from ibl_nerf_tpu_torch.render import renderer
from ibl_nerf_tpu_torch.render.config import EditConfig
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_fused_field_f64 import RENDER_ATOL, RENDER_RTOL, render_f64_both  # noqa: E402

torch.set_num_threads(2)

FIELD = dict(depth=8, width=32, coarse_radiance_number=3)
BASE = dict(n_samples=8, n_importance=8, perturb=False,
            approximate_radiance=True,
            normal_type="normal_map_from_depth_gradient_epsilon",
            correct_depth_for_prefiltered_radiance_infer=True)
SHADED = {"color_map", "specular_map", "diffuse_map", "n_dot_v_map",
          "target_normal_map", "normal_map_from_depth_gradient_epsilon",
          "normal_map_from_depth_gradient_direction_epsilon",
          "reflected_radiance_map", "prefiltered_reflected_map"}


def _cfgs(**kw):
    jr = JRenderConfig(field=JFieldConfig(**FIELD), **BASE).replace(**kw)
    fields = {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)}
    for name in ("field", "field_fine"):
        if fields[name] is not None:
            fields[name] = FieldConfig(**dataclasses.asdict(fields[name]))
    return jr, RenderConfig(**fields)


@pytest.fixture(scope="module")
def setup():
    jcfg = JFieldConfig(**FIELD)
    k1, k2 = jax.random.split(jax.random.key(7))
    jvars = {"coarse": j_init(k1, jcfg), "fine": j_init(k2, jcfg)}
    for v in jvars.values():  # visible density, so depth and normals mean something
        v["sigma"]["b"] = v["sigma"]["b"] + 0.5
    tvars = field_params_from_numpy(jax.tree.map(np.asarray, jvars), "cpu")
    jconsts = {"brdf_lut": jnp.asarray(j_load_lut())}
    tconsts = {"brdf_lut": load_brdf_lut(device="cpu")}
    rng = np.random.default_rng(3)
    rays_o = (rng.standard_normal((8, 3)) * 0.1).astype(np.float32)
    rays_d = rng.standard_normal((8, 3)).astype(np.float32)
    return jvars, tvars, jconsts, tconsts, rays_o, rays_d


def _render_both(setup, is_depth_only=False, **kw):
    jvars, tvars, jconsts, tconsts, rays_o, rays_d = setup
    jr, tr = _cfgs(**kw)
    ref = jax.jit(lambda b: j_render_rays(jax.random.key(0), jvars, jconsts, b, jr,
                                          is_depth_only=is_depth_only))(
        j_batch(jnp.asarray(rays_o), jnp.asarray(rays_d), 2.0, 6.0))
    out = render_rays(tvars, tconsts, make_ray_batch(
        torch.from_numpy(rays_o), torch.from_numpy(rays_d), 2.0, 6.0), tr,
        is_depth_only=is_depth_only)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in out.items()}


def noise_draws(key, n, rcfg, is_depth_only=False):
    """JAX's raw-noise draws of render_rays(key) for n rays under `rcfg`
    (perturb off): standard normals from k_coarse and k_fine, split once
    more in a shading pass, none in a depth-only one."""
    _, k_coarse, _, k_fine = jax.random.split(key, 4)
    coarse_depth_only = is_depth_only or not rcfg.coarse_shading

    def normals(k, depth_only, m):
        k = k if depth_only else jax.random.split(k)[0]
        return torch.from_numpy(np.array(jax.random.normal(k, (n, m))))

    return {"noise_coarse": normals(k_coarse, coarse_depth_only, rcfg.n_samples),
            "noise_fine": normals(k_fine, is_depth_only,
                                  rcfg.n_samples + rcfg.n_importance)}


def _assert_maps(ref, out, basic_tol=(5e-4, 1e-3), shaded_tol=(2e-3, 5e-3)):
    assert set(out) == set(ref)
    for k, r in ref.items():
        atol, rtol = shaded_tol if k.rstrip("0") in SHADED else basic_tol
        assert out[k].shape == r.shape, k
        np.testing.assert_allclose(out[k], r, atol=atol, rtol=rtol, err_msg=k)


# each value of each switch, in pairs that cover every two-way combination
# of use_pallas with the other two
@pytest.mark.parametrize("use_pallas,coarse_shading,sweep_scan", [
    (False, True, False), (True, True, True), (False, False, True),
    (True, False, False),
], ids=["eager-coarse-batched", "k1-coarse-scan", "eager-fast-scan",
        "k1-fast-batched"])
def test_render_rays_float32(setup, use_pallas, coarse_shading, sweep_scan):
    ref, out = _render_both(setup, use_pallas=use_pallas,
                            coarse_shading=coarse_shading, sweep_scan=sweep_scan)
    assert "target_normal_map" in out and "color_map" in out
    assert ("color_map0" in out) == coarse_shading
    _assert_maps(ref, out)


@pytest.mark.parametrize("kw", [
    dict(normal_type="normal_map_from_depth_gradient_direction_epsilon",
         use_pallas=True),
    dict(use_radiance_linear=True, gamma_correct=True, lut_coefficient="F0",
         correct_depth_for_prefiltered_radiance_infer=False),
    dict(approximate_radiance=False),
], ids=["direction_eps", "hdr_gamma_F0", "unshaded"])
def test_render_rays_modes(setup, kw):
    _assert_maps(*_render_both(setup, **kw))


def test_render_rays_depth_only(setup):
    ref, out = _render_both(setup, is_depth_only=True)
    assert "depth_map" in out and "visibility0" in out
    _assert_maps(ref, out)


def test_render_rays_distinct_fine_field(setup):
    """field_fine: the fine pass runs another architecture (depth 4,
    width 16) on its own weights."""
    jvars, tvars, jconsts, tconsts, rays_o, rays_d = setup
    fine = JFieldConfig(depth=4, width=16, coarse_radiance_number=3)
    jf = dict(jvars, fine=j_init(jax.random.key(11), fine))
    tf = dict(tvars, fine=field_params_from_numpy(
        jax.tree.map(np.asarray, jf["fine"]), "cpu"))
    _assert_maps(*_render_both((jf, tf, jconsts, tconsts, rays_o, rays_d),
                               field_fine=fine, use_pallas=False))


def test_render_image(setup):
    jvars, tvars, jconsts, tconsts, _, _ = setup
    jr, tr = _cfgs(coarse_shading=False, use_pallas=True)
    scene = _Scene()
    K = np.array([[7.0, 0, 4.0], [0, 7.0, 3.0], [0, 0, 1]], np.float32)
    fn = jax.jit(lambda k, b, g: j_render_rays(k, jvars, jconsts, b, jr, g))
    ref = j_render_image(jax.random.key(0), jvars, jconsts, 6, 8, jnp.asarray(K),
                         jnp.asarray(scene.poses[0]), 2.0, 6.0, jr, chunk=16,
                         render_fn=fn)
    out = render_image(tvars, tconsts, 6, 8, torch.from_numpy(K),
                       torch.from_numpy(scene.poses[0]), 2.0, 6.0, tr, chunk=16)
    assert out["color_map"].shape == (6, 8, 3)
    _assert_maps({k: np.asarray(v) for k, v in ref.items()},
                 {k: v.numpy() for k, v in out.items()})


def test_render_rays_bf16_grad(setup):
    """compute_dtype bf16_grad: bf16 primary march (f32 raw heads), f32
    no-grad sweeps on K1. bf16 keeps 8 mantissa bits and XLA and torch
    sum the bf16 products in another order, so a hidden unit can round
    to the neighbouring bf16 value (2^-8 relative); the coarse weights,
    and with them the importance samples and the ε-normals, move with
    it. On this input the worst map differs by 2.0e-3 (the normals);
    atol/rtol 1e-2 keeps a 5x margin and is still two orders below what
    a wrong head or a missing cast gives."""
    ref, out = _render_both(setup, compute_dtype="bf16_grad", use_pallas=True,
                            coarse_shading=False)
    _assert_maps(ref, out, basic_tol=(1e-2, 1e-2), shaded_tol=(1e-2, 1e-2))


def test_frame_render_matches_render_rays(setup):
    """Tiling with padding (21 rays, chunk 8 -> 3 tiles, the last padded
    by repeating the last ray) gives the same maps as one batch."""
    _, tvars, _, tconsts, rays_o, rays_d = setup
    _, tr = _cfgs(coarse_shading=False)
    ro, rd = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    ro, rd = torch.cat([ro, ro, ro[:5]]), torch.cat([rd, rd, rd[:5]])
    keys = ("color_map", "depth_map", "target_normal_map")
    fn = make_frame_render_fn(tvars, tconsts, tr, output_keys=keys)
    out = render_frame(fn, ro, rd, 2.0, 6.0, chunk=8)
    ref = render_rays(tvars, tconsts, make_ray_batch(ro, rd, 2.0, 6.0), tr)
    assert set(out) == set(keys)
    for k in keys:
        assert out[k].shape[0] == 21
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=1e-6,
                                   err_msg=k)


class _Scene:
    height, width, focal, near, far = 6, 8, 7.0, 2.0, 6.0

    def __init__(self):
        rng = np.random.default_rng(9)
        poses = []
        for _ in range(2):
            q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            poses.append(np.concatenate([q, rng.standard_normal((3, 1)) * 0.1], 1))
        self.poses = np.stack(poses).astype(np.float32)

    def gt_buffers(self):
        return {}


def test_render_path(setup):
    jvars, tvars, jconsts, tconsts, _, _ = setup
    jr, tr = _cfgs(use_pallas=True)
    scene = _Scene()
    ref = j_render_path(jvars, jconsts, scene, jr, savedir=None, chunk=16)
    out = render_path(tvars, tconsts, scene, tr, chunk=16)
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert out[k].shape == r.shape, k
        assert out[k].shape[:3] == (2, 6, 8), k
        shaded = k in ("rgb", "specular", "diffuse", "n_dot_v", "target_normal_map",
                       "reflected_radiance", "prefiltered_reflected",
                       "normal_from_depth") or k.startswith("reflected_coarse")
        atol, rtol = (2e-3, 5e-3) if shaded else (5e-4, 1e-3)
        np.testing.assert_allclose(out[k], r, atol=atol, rtol=rtol, err_msg=k)


# the modes refused until their slice, with a map each renders now
PORTED_MODES = {"infer_normal": "inferred_normal_map", "monte_carlo": "specular_map",
                "infer_depth": "inferred_depth_map", "infer_albedo_separate": "albedo_map",
                "infer_roughness_separate": "roughness_map",
                "infer_irradiance_separate": "irradiance_map"}


@pytest.mark.parametrize("kw,mode", [
    (dict(normal_type="inferred_normal_map", infer_normal=True), "infer_normal"),
    (dict(normal_type="ground_truth", shading_mode="monte_carlo"), "monte_carlo"),
    (dict(normal_type="inferred_normal_map"), "normal_type"),
    (dict(shading_mode="monte_carlo"), "monte_carlo"),
    (dict(edit=EditConfig(), raw_noise_std=1.0), "raw_noise_std"),
    (dict(infer_normal=True), "infer_normal"),
    (dict(infer_depth=True), "infer_depth"),
    (dict(infer_albedo_separate=True), "infer_albedo_separate"),
    (dict(infer_roughness_separate=True), "infer_roughness_separate"),
    (dict(raw_noise_std=0.5), "raw_noise_std"),
    (dict(compute_dtype="float64", use_pallas=True), "float64 with use_pallas"),
    (dict(infer_irradiance_separate=True), "infer_irradiance_separate"),
])
def test_uncovered_modes_raise(setup, kw, mode):
    """Modes the port does not cover raise NotImplementedError naming the
    mode. The aux heads and Monte-Carlo shading, refused here until they
    were ported, now render their maps (tests/test_torch_aux.py and
    tests/test_torch_mc_shading.py hold them against JAX); so does
    raw_noise_std, refused until it was ported, held here to JAX's render
    with JAX's noise (alone and under an edit), and so does float64 with
    use_pallas, held to JAX's f64 render within the bounds of
    tests/test_torch_fused_field_f64.py, K1 at f64 weights on its two
    no-grad sweeps; shading with the inferred normal but no normal head is
    a ValueError."""
    jvars, tvars, jconsts, tconsts, rays_o, rays_d = setup
    jr, tr = _cfgs(**kw)
    batch = make_ray_batch(torch.from_numpy(rays_o), torch.from_numpy(rays_d), 2.0, 6.0)
    if mode == "raw_noise_std":
        n = rays_o.shape[0]
        gt = {"edit_intrinsic_mask": np.full((n, 3), 10 / 255, np.float32)} if tr.edit else {}
        ref = j_render_rays(jax.random.key(0), jvars, jconsts,
                            j_batch(jnp.asarray(rays_o), jnp.asarray(rays_d), 2.0, 6.0), jr,
                            gt_values={k: jnp.asarray(v) for k, v in gt.items()} or None)
        out = render_rays(tvars, tconsts, batch, tr, draws=noise_draws(jax.random.key(0), n, tr),
                          gt_values={k: torch.from_numpy(v) for k, v in gt.items()} or None)
        _assert_maps({k: np.asarray(v) for k, v in ref.items()},
                     {k: v.numpy() for k, v in out.items()})
    elif mode in PORTED_MODES:
        rng, in_ch = np.random.default_rng(0), tr.field.input_ch
        aux = {name: init_position_mlp(rng, 8, 32, in_ch, out_ch, device="cpu")
               for name, out_ch in (("normal_mlp", 3), ("albedo_mlp", 3),
                                    ("roughness_mlp", 1), ("irradiance_mlp", 1))}
        aux["depth_mlp"] = init_position_direction_mlp(rng, 8, 32, in_ch,
                                                       tr.field.input_ch_views, 1, device="cpu")
        gt = {"normal": torch.tensor([0.5, 0.5, 1.0]).expand(rays_o.shape[0], 3)}
        out = render_rays({**tvars, **aux}, tconsts, batch, tr, gt_values=gt)
        assert torch.isfinite(out[PORTED_MODES[mode]]).all()
    elif mode == "float64 with use_pallas":
        # refused until K1 had its f64 kernel; now held to JAX's f64 render,
        # both sides running K1 at f64 weights on the no-grad sweeps
        ref, out, calls = render_f64_both(dict(
            jvars=jax.tree.map(np.asarray, jvars), lut=np.asarray(jconsts["brdf_lut"]),
            rays_o=rays_o, rays_d=rays_d))
        assert calls == [(torch.float64, True), (torch.float64, False)] * 2  # coarse, fine
        _assert_maps(ref, out, basic_tol=(RENDER_ATOL, RENDER_RTOL),
                     shaded_tol=(RENDER_ATOL, RENDER_RTOL))
    elif mode == "normal_type":
        with pytest.raises(ValueError, match="infer_normal"):
            render_rays(tvars, tconsts, batch, tr)
    else:
        with pytest.raises(NotImplementedError, match=mode):
            render_rays(tvars, tconsts, batch, tr)


@pytest.mark.parametrize("normal_type,aliased", [
    ("normal_map_from_depth_gradient_epsilon", True),
    ("normal_map_from_sigma_gradient", True),
    ("ground_truth", False),
])
def test_normal_estimator_key_only_for_normal_map_types(normal_type, aliased):
    """The estimator's own key joins the maps only for the normal_map_*
    estimators, as in the JAX renderer; target_normal_map always does."""
    _, tr = _cfgs(normal_type=normal_type)
    m, s = torch.zeros(2, 3), torch.zeros(2)
    out = renderer._assemble_outputs(tr, m, m, [], [], m[:, :1], m, m, m, s, m, m, s, m,
                                     s, s, s, torch.zeros(2, 4))
    assert "target_normal_map" in out
    assert (normal_type in out) == aliased
    assert set(out) - {normal_type} == set(renderer._assemble_outputs(
        _cfgs(normal_type="ground_truth")[1], m, m, [], [], m[:, :1], m, m, m, s, m, m, s,
        m, s, s, s, torch.zeros(2, 4)))

