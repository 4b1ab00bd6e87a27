"""The port's Monte-Carlo GGX shading against the JAX package's.

- `hemisphere_samples` (numpy) bit for bit against JAX's at several
  grid sizes and offsets; `uniform_hemisphere_samples` on JAX's own
  uniforms (1e-6).
- `get_tbn` on unit normals held 1e-3 away from its branch (normal x =
  normal z, where the frame jumps), and `microfacet_brdf` and its parts
  (`ggx_distribution`, `ggx_geometry`, `schlick_fresnel`) against JAX's
  (atol 1e-6 / rtol 1e-5).
- `render_rays(shading_mode="monte_carlo")` against JAX (depth 8, width
  32, K=3, 8 rays, 8 + 8 samples, 9 hemisphere directions, float32):
  eager with ε normals; with `use_pallas`, where the port's K1 wrapper
  takes its plain version on these CPU tensors and JAX runs its Pallas
  kernel in interpret mode; and shading with the inferred normal; atol
  5e-4 / rtol 1e-3 on the basic maps, 2e-3 / 5e-3 on the shaded ones.
  Then, under gt normals, the gradients of one loss on the shaded color
  to the fine field's albedo, roughness and trunk against `jax.grad`
  (relative norm 1e-3).
- The JAX test's Lambert limit and linearity in the incident radiance
  (tests/test_mc_shading.py) on the port's estimator.
- `cli.test` on one checkpoint per side with every aux head, Monte-Carlo
  shading and the inferred normal: every buffer of JAX's within the
  same tolerances, and the same PNG names. A CPU training run under
  Monte-Carlo shading with the aux heads: finite losses past the switch.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.cli import test as j_test_cli
from ibl_nerf_tpu.cli.config import parse_with_includes as j_parse
from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_load_lut
from ibl_nerf_tpu.models.aux_mlp import init_position_mlp
from ibl_nerf_tpu.models.field import FieldConfig as JFieldConfig
from ibl_nerf_tpu.models.field import init_field_params as j_init
from ibl_nerf_tpu.ops import geometry as j_geometry
from ibl_nerf_tpu.ops import shading as j_shading
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.render import make_ray_batch as j_batch
from ibl_nerf_tpu.render import render_rays as j_render_rays
from ibl_nerf_tpu.train import checkpoint as j_ckpt
from ibl_nerf_tpu.train import loop as j_loop
from ibl_nerf_tpu.train import step as j_step
from ibl_nerf_tpu_torch.cli import test as test_cli
from ibl_nerf_tpu_torch.cli.config import parse_with_includes
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.models.field import FieldConfig
from ibl_nerf_tpu_torch.ops import geometry, shading
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.render.renderer import _monte_carlo_shading
from ibl_nerf_tpu_torch.train import checkpoint as ckpt_lib
from ibl_nerf_tpu_torch.train import loop
from ibl_nerf_tpu_torch.train import step as t_step
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_scene import make_scene  # noqa: E402

torch.set_num_threads(2)

BASIC_TOL, SHADED_TOL = (5e-4, 1e-3), (2e-3, 5e-3)
SHADED = {"color_map", "specular_map", "diffuse_map", "n_dot_v_map", "target_normal_map",
          "inferred_normal_map", "normal_map_from_depth_gradient_epsilon"}
FIELD = dict(depth=8, width=32, coarse_radiance_number=3)
EPS = "normal_map_from_depth_gradient_epsilon"
B = 8


def _t(a):
    return torch.from_numpy(np.array(a))


# --- the samplers and the BRDF ---------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 16])
def test_hemisphere_samples_are_bit_exact(n):
    for offset in ((0.5, 0.5), (0.0, 0.0), (0.25, 0.75), (1.0, 0.0)):
        ours = geometry.hemisphere_samples(n, offset)
        theirs = j_geometry.hemisphere_samples(n, offset)
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    # the map itself on a grid through every octant edge and the centre
    u, v = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 9))
    np.testing.assert_array_equal(geometry._map_uv_to_direction(u, v),
                                  j_geometry._map_uv_to_direction(u, v))


def test_uniform_hemisphere_samples_match_jax():
    key = jax.random.key(4)
    ref = j_geometry.uniform_hemisphere_samples(key, 64)
    out = geometry.uniform_hemisphere_samples(_t(jax.random.uniform(key, (64, 2))))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    assert (out[:, 2] >= 0).all()


def _unit_normals(rng, n):
    x = rng.standard_normal((4 * n, 3))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x = x[np.abs(x[:, 0] - x[:, 2]) > 1e-3][:n]   # away from get_tbn's branch
    return x.astype(np.float32)


def test_get_tbn_matches_jax():
    normal = _unit_normals(np.random.default_rng(0), 256)
    for ours, theirs in zip(geometry.get_tbn(_t(normal)), j_geometry.get_tbn(jnp.asarray(normal))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)


def test_microfacet_brdf_and_parts_match_jax():
    rng = np.random.default_rng(1)
    n, l = 32, 9
    pts2l = rng.standard_normal((n, l, 3)).astype(np.float32)
    pts2c = rng.standard_normal((n, 3)).astype(np.float32)
    normal = _unit_normals(rng, n)
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rough = rng.uniform(0.05, 1, (n, 1)).astype(np.float32)
    h = pts2l / np.linalg.norm(pts2l, axis=-1, keepdims=True)
    cos = rng.uniform(0, 1, (n, l)).astype(np.float32)

    def close(ours, theirs):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6, rtol=1e-5)

    close(shading.ggx_distribution(_t(h), _t(normal), _t(rough) ** 2),
          j_shading.ggx_distribution(jnp.asarray(h), jnp.asarray(normal),
                                     jnp.asarray(rough) ** 2))
    close(shading.ggx_geometry(_t(cos[:, :1]), _t(cos), _t(rough)),
          j_shading.ggx_geometry(jnp.asarray(cos[:, :1]), jnp.asarray(cos), jnp.asarray(rough)))
    close(shading.schlick_fresnel(_t(h), _t(h[:, ::-1]), _t(albedo)),
          j_shading.schlick_fresnel(jnp.asarray(h), jnp.asarray(h[:, ::-1]),
                                    jnp.asarray(albedo)))
    for kw in (dict(albedo=albedo, rough=rough), {}):
        ours = shading.microfacet_brdf(_t(pts2l), _t(pts2c), _t(normal),
                                       **{k: _t(v) for k, v in kw.items()})
        theirs = j_shading.microfacet_brdf(jnp.asarray(pts2l), jnp.asarray(pts2c),
                                           jnp.asarray(normal),
                                           **{k: jnp.asarray(v) for k, v in kw.items()})
        for a, b in zip(ours, theirs):
            close(a, b)


# --- render_rays under Monte-Carlo shading -------------------------------------------

def _cfgs(**kw):
    base = dict(n_samples=8, n_importance=8, perturb=False, approximate_radiance=True,
                shading_mode="monte_carlo", mc_samples_axis=3, normal_type=EPS,
                compute_dtype="float32")
    jr = JRenderConfig(field=JFieldConfig(**FIELD), **base).replace(**kw)
    fields = {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)}
    fields["field"] = FieldConfig(**dataclasses.asdict(fields["field"]))
    return jr, RenderConfig(**fields)


@pytest.fixture(scope="module")
def setup():
    jcfg = JFieldConfig(**FIELD)
    k1, k2, k3 = jax.random.split(jax.random.key(11), 3)
    jv = {"coarse": j_init(k1, jcfg), "fine": j_init(k2, jcfg),
          "normal_mlp": init_position_mlp(k3, 8, 32, jcfg.input_ch, 3)}
    for name in ("coarse", "fine"):  # visible density
        jv[name]["sigma"]["b"] = jv[name]["sigma"]["b"] + 0.5
    tv = field_params_from_numpy(jax.tree.map(np.asarray, jv), "cpu")
    rng = np.random.default_rng(5)
    rays_o = (rng.standard_normal((B, 3)) * 0.1).astype(np.float32)
    rays_d = rng.standard_normal((B, 3)).astype(np.float32)
    return (jv, tv, {"brdf_lut": jnp.asarray(j_load_lut())},
            {"brdf_lut": load_brdf_lut(device="cpu")}, rays_o, rays_d)


MC_MODES = {"eager": {}, "k1": dict(use_pallas=True),
            "inferred_normal": dict(infer_normal=True, normal_type="inferred_normal_map")}


@pytest.mark.parametrize("mode", list(MC_MODES))
def test_render_rays_monte_carlo_matches_jax(setup, mode):
    jv, tv, jc, tc, rays_o, rays_d = setup
    jr, tr = _cfgs(**MC_MODES[mode])
    ref = jax.jit(lambda b: j_render_rays(jax.random.key(0), jv, jc, b, jr))(
        j_batch(jnp.asarray(rays_o), jnp.asarray(rays_d), 2.0, 6.0))
    out = render_rays(tv, tc, make_ray_batch(_t(rays_o), _t(rays_d), 2.0, 6.0), tr)
    assert set(out) == set(ref)
    assert not {"reflected_radiance_map", "prefiltered_reflected_map",
                "reflected_coarse_radiance_map_1"} & set(out)
    for k, r in ref.items():
        atol, rtol = SHADED_TOL if k.rstrip("0") in SHADED else BASIC_TOL
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(r), atol=atol,
                                   rtol=rtol, err_msg=k)
    assert float(out["specular_map"].abs().max()) > 0 and float(out["diffuse_map"].max()) > 0


def test_monte_carlo_gradients_match_jax(setup):
    """Under gt normals: an ε normal is a difference of sums over sin of
    2^9 x, whose last-bit differences between XLA and torch the GGX lobe
    carries into the roughness gradient (~5e-3 here)."""
    jv, tv, jc, tc, rays_o, rays_d = setup
    jr, tr = _cfgs(normal_type="ground_truth")
    jvars = {k: jv[k] for k in ("coarse", "fine")}
    gt = np.random.default_rng(6).uniform(0, 1, (B, 3)).astype(np.float32)

    def j_loss(variables):
        out = j_render_rays(jax.random.key(0), variables, jc,
                            j_batch(jnp.asarray(rays_o), jnp.asarray(rays_d), 2.0, 6.0), jr,
                            gt_values={"normal": jnp.asarray(gt)})
        return jnp.mean(out["color_map"] ** 2)

    jgrads = jax.jit(jax.grad(j_loss))(jvars)
    tvars = {k: t_step._unflatten(tv[k], [p.clone().requires_grad_(True)
                                          for p in t_step._leaves(tv[k])])
             for k in ("coarse", "fine")}
    out = render_rays(tvars, tc, make_ray_batch(_t(rays_o), _t(rays_d), 2.0, 6.0), tr,
                      gt_values={"normal": _t(gt)})
    heads = ("albedo", "roughness", "trunk")
    leaves = [p for h in heads for p in t_step._leaves(tvars["fine"][h])]
    grads = torch.autograd.grad(torch.mean(out["color_map"] ** 2), leaves, allow_unused=True)
    grads = iter(grads)
    for h in heads:
        theirs = np.concatenate([np.asarray(x).reshape(-1)
                                 for x in jax.tree.leaves(jgrads["fine"][h])])
        ours = np.concatenate([next(grads).numpy().reshape(-1)
                               for _ in t_step._leaves(tvars["fine"][h])])
        assert np.abs(theirs).max() > 0, h
        assert np.linalg.norm(ours - theirs) / np.linalg.norm(theirs) < 1e-3, h


# --- the JAX test's semantic cases on the port ------------------------------------------

def _logit(p):
    return float(np.log(p / (1.0 - p)))


def _constant_query(level, s):
    """A field opaque at its first sample with radiance `level`, as the
    incident march queries it: the "incident" head set's [σ, rad3]."""
    def query(pts, dirs, heads):
        assert heads == "incident"
        raw = torch.zeros((pts.shape[0], s, 4))
        raw[..., 0] = 1e4
        raw[..., 1:4] = _logit(level)
        return raw
    return query


def test_lambert_limit():
    """Constant incident radiance and roughness 1 (metallic 0): the
    diffuse estimate approaches (1 - F) albedo L."""
    b, s, incident = 4, 8, 0.7
    albedo = np.array([0.8, 0.5, 0.2], np.float32)
    rcfg = RenderConfig(field=FieldConfig(coarse_radiance_number=0), mc_samples_axis=16)
    rng = np.random.default_rng(0)
    rays_d = torch.nn.functional.normalize(_t(rng.standard_normal((b, 3)).astype(np.float32)),
                                           dim=-1)
    z_vals = torch.linspace(0.1, 2.0, s).expand(b, s)
    diffuse, specular = _monte_carlo_shading(
        _constant_query(incident, s), rays_d, torch.zeros((b, 3)), z_vals, -rays_d,
        _t(albedo).expand(b, 3), torch.ones((b,)), rcfg)
    expect = albedo * incident * (1.0 - 0.04)
    np.testing.assert_allclose(diffuse.numpy(), np.broadcast_to(expect, (b, 3)), rtol=0.12)
    assert torch.isfinite(specular).all() and (specular >= 0).all()


def test_energy_scales_with_incident():
    """Doubling the incident radiance doubles the shading."""
    b, s = 3, 4
    rcfg = RenderConfig(field=FieldConfig(coarse_radiance_number=0), mc_samples_axis=4)
    rays_d = torch.tensor([[0.0, 0.0, 1.0]]).expand(b, 3)
    args = (rays_d, torch.zeros((b, 3)), torch.linspace(0.1, 2.0, s).expand(b, s), -rays_d,
            torch.full((b, 3), 0.5), torch.full((b,), 0.4), rcfg)
    d1, s1 = _monte_carlo_shading(_constant_query(0.2, s), *args)
    d2, s2 = _monte_carlo_shading(_constant_query(0.4, s), *args)
    np.testing.assert_allclose(d2.numpy(), 2 * d1.numpy(), rtol=1e-4)
    np.testing.assert_allclose(s2.numpy(), 2 * s1.numpy(), rtol=1e-4)


# --- the CLIs ---------------------------------------------------------------------------

AUX_FLAGS = ("--infer_normal", "--infer_depth", "--infer_albedo_separate",
             "--infer_roughness_separate", "--infer_irradiance_separate", "--infer_visibility",
             "--use_environment_map")
STEP = 5


def _argv(scene_dir, base, *extra):
    return ["--datadir", scene_dir, "--basedir", os.path.join(base, "logs"),
            "--expname", "exp", "--netdepth", "4", "--netwidth", "32", "--N_samples", "8",
            "--N_importance", "8", "--coarse_radiance_number", "2",
            "--load_depth_range_from_file", "--render_factor", "4", "--testskip", "1",
            "--compute_dtype", "float32", "--N_envmap_size", "4", *AUX_FLAGS, *extra]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("mc_scene")))


def test_cli_test_with_aux_heads_and_monte_carlo_matches_jax(scene_dir, tmp_path):
    bases = {side: str(tmp_path / side) for side in ("port", "jax")}
    args = j_parse(_argv(scene_dir, bases["jax"]))
    jvars = j_loop.init_variables(jax.random.key(3), args, j_loop.field_config_from_args(args))
    for name in ("coarse", "fine"):
        jvars[name]["sigma"]["b"] = jvars[name]["sigma"]["b"] + 0.5
    jvars["depth_mlp"]["out"]["b"] = jvars["depth_mlp"]["out"]["b"] + 3.0
    jopt = j_step.build_optimizer(jvars, lcfg=j_loop.loss_config_from_args(args))
    j_ckpt.save_checkpoint(os.path.join(bases["jax"], "logs", "exp"), STEP,
                           j_step.init_train_state(jvars, jopt), 0.0)
    tvars = field_params_from_numpy(jax.tree.map(np.asarray, jvars), "cpu")
    ckpt_lib.save_checkpoint(os.path.join(bases["port"], "logs", "exp"), STEP,
                             t_step.init_train_state(tvars, t_step.build_optimizer(tvars)), 0.0)

    extra = ("--shading_mode", "monte_carlo", "--calculating_normal_type", "inferred_normal_map")
    out = test_cli.run_test(parse_with_includes(_argv(scene_dir, bases["port"], *extra)),
                            device="cpu")
    ref = j_test_cli.run_test(j_parse(_argv(scene_dir, bases["jax"], *extra)))
    assert set(out) == set(ref)
    assert {"inferred_normal_map", "inferred_disp", "rgb", "specular"} <= set(out)
    assert not {"reflected_radiance", "prefiltered_reflected"} & set(out)
    for k, r in ref.items():
        assert out[k].shape == r.shape, k
        shaded = k.startswith(("rgb", "specular", "diffuse", "n_dot_v", "target_normal_map",
                               "inferred_normal_map", "normal_from_depth"))
        atol, rtol = SHADED_TOL if shaded else BASIC_TOL
        np.testing.assert_allclose(out[k], r, atol=atol, rtol=rtol, err_msg=k)
    dirs = [os.path.join(bases[s], "logs_eval", "exp", f"testset_{STEP:06d}")
            for s in ("port", "jax")]
    pngs = [sorted(n for n in os.listdir(d) if n.endswith(".png")) for d in dirs]
    assert pngs[0] == pngs[1]
    assert {"inferred_normal_map_001.png", "inferred_disp_001.png"} <= set(pngs[0])


def test_monte_carlo_training_run(scene_dir, tmp_path):
    argv = _argv(scene_dir, str(tmp_path), "--N_rand", "16", "--N_iter", "3",
                 "--N_iter_ignore_approximated_radiance", "1", "--N_iter_ignore_normal", "1",
                 "--N_iter_ignore_depth", "1", "--N_depth_random_volume", "8",
                 "--netwidth", "16", "--i_weights", "3", "--i_testset", "100",
                 "--summary_step", "1", "--shading_mode", "monte_carlo", "--mc_samples_axis",
                 "2")
    state = loop.train(parse_with_includes(argv), device="cpu")
    assert state.step == 4
    with open(os.path.join(str(tmp_path), "logs", "exp", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [0, 1, 2, 3]
    for r in records[1:]:
        for k in ("loss_total", "loss_render", "loss_inferred_normal", "loss_depth"):
            assert np.isfinite(r[k]) and r[k] > 0, (r["step"], k)
