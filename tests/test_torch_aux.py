"""The port's auxiliary heads, environment map and depth-volume pass
against the JAX package's.

- The aux MLPs (`models/aux_mlp`) against JAX's apply functions on the
  same params and inputs (atol 1e-5), and the reference-state converters
  of `utils/port` on one synthetic state dict (equal).
- `init_envmap`'s shapes, `sample_envmap` and its gradient to the
  emission against JAX's (atol 1e-5: atan2 and acos of XLA and of torch
  differ in the last bits, and the texel coordinates scale them by the
  map's size).
- `render_rays` with each aux flag (the inferred normal per sample and
  at the surface point, `normal_type=inferred_normal_map`, the inferred
  depth, also on a depth-only pass, the separate albedo, roughness and
  irradiance) against JAX: depth 8, width 32, 8 rays, 8 + 8 samples, gt
  normals under the other flags, float32; atol 5e-4 / rtol 1e-3 on the
  basic maps, 2e-3 / 5e-3 on the shaded ones.
- One float32 train step with the inferred normal and depth, their
  losses on and the depth-volume pass, the draws (the volume's
  directions and render uniforms too) made by jax.random and passed in,
  against JAX's `make_train_step`: the loss within 1e-4 (relative), each
  param group's gradient, the aux groups too, within 2e-4 (relative
  norm; tests/test_torch_gt_inputs.py's bound), and the update.
- `train/loop.init_variables` with every aux flag: JAX's keys, in JAX's
  order, and shapes.
- A CPU `train` with every aux flag past the normal and depth switch:
  its checkpoints carry JAX's groups; each aux group is unchanged before
  its start offset and moves after it, the visibility head and the
  environment map (read by no renderer) never move.
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

from ibl_nerf_tpu.cli.config import parse_with_includes as j_parse
from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_load_lut
from ibl_nerf_tpu.data.sampler import sample_pixel_batch as j_sample
from ibl_nerf_tpu.models import aux_mlp as j_aux
from ibl_nerf_tpu.models import envmap as j_envmap
from ibl_nerf_tpu.models.field import FieldConfig as JFieldConfig
from ibl_nerf_tpu.models.field import init_field_params as j_init
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.render import make_ray_batch as j_batch
from ibl_nerf_tpu.render import render_rays as j_render_rays
from ibl_nerf_tpu.train import loop as j_loop
from ibl_nerf_tpu.train import losses as jlosses
from ibl_nerf_tpu.train import step as jstep
from ibl_nerf_tpu.utils import port as j_port
from ibl_nerf_tpu_torch.cli.config import parse_with_includes
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.models import aux_mlp, envmap
from ibl_nerf_tpu_torch.models.field import FieldConfig
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.train import checkpoint as ckpt_lib
from ibl_nerf_tpu_torch.train import loop
from ibl_nerf_tpu_torch.train import losses as tlosses
from ibl_nerf_tpu_torch.train import step as tstep
from ibl_nerf_tpu_torch.utils import port
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_scene import make_scene  # noqa: E402

torch.set_num_threads(2)

FIELD = dict(depth=8, width=32, coarse_radiance_number=3)
BASIC_TOL, SHADED_TOL = (5e-4, 1e-3), (2e-3, 5e-3)
SHADED = {"color_map", "specular_map", "diffuse_map", "n_dot_v_map", "target_normal_map",
          "reflected_radiance_map", "prefiltered_reflected_map", "inferred_normal_map"}
B = 8
AUX_HEADS = {"normal_mlp": 3, "albedo_mlp": 3, "roughness_mlp": 1, "irradiance_mlp": 1}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --- the aux MLPs and the converters --------------------------------------------

def test_aux_mlps_match_jax():
    k1, k2 = jax.random.split(jax.random.key(1))
    rng = np.random.default_rng(0)
    pe = rng.standard_normal((2, 64, 63)).astype(np.float32)
    de = rng.standard_normal((2, 64, 27)).astype(np.float32)
    jp = j_aux.init_position_mlp(k1, 8, 32, 63, 3)
    jpd = j_aux.init_position_direction_mlp(k2, 8, 32, 63, 27, 1)
    ref = j_aux.apply_position_mlp(jp, jnp.asarray(pe))
    out = aux_mlp.apply_position_mlp(field_params_from_numpy(_np(jp), "cpu"), _t(pe))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    ref = j_aux.apply_position_direction_mlp(jpd, jnp.asarray(pe), jnp.asarray(de))
    out = aux_mlp.apply_position_direction_mlp(field_params_from_numpy(_np(jpd), "cpu"),
                                               _t(pe), _t(de))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert out.shape == (2, 64, 1)


def test_aux_mlp_inits_have_jax_shapes():
    rng = np.random.default_rng(0)
    for ours, theirs in (
            (aux_mlp.init_position_mlp(rng, 8, 32, 63, 3, device="cpu"),
             j_aux.init_position_mlp(jax.random.key(0), 8, 32, 63, 3)),
            (aux_mlp.init_position_direction_mlp(rng, 8, 32, 63, 27, 1, device="cpu"),
             j_aux.init_position_direction_mlp(jax.random.key(0), 8, 32, 63, 27, 1))):
        assert (jax.tree.structure(jax.tree.map(lambda x: 0, ours))
                == jax.tree.structure(jax.tree.map(lambda x: 0, theirs)))
        assert ([tuple(x.shape) for x in jax.tree.leaves(ours)]
                == [tuple(x.shape) for x in jax.tree.leaves(theirs)])


def test_torch_state_converters_match_jax():
    rng = np.random.default_rng(2)
    depth, w = 4, 16

    def lin(fan_in, fan_out):
        return rng.standard_normal((fan_out, fan_in)).astype(np.float32), \
            rng.standard_normal(fan_out).astype(np.float32)

    sd = {}
    for i in range(depth):
        sd[f"positions_linears.{i}.weight"], sd[f"positions_linears.{i}.bias"] = lin(
            63 if i == 0 else w, w)
    sd["out_linears.weight"], sd["out_linears.bias"] = lin(w, 3)
    sd["feature_linear.weight"], sd["feature_linear.bias"] = lin(w, w)
    for i in range(depth // 2):
        sd[f"views_linears.{i}.weight"], sd[f"views_linears.{i}.bias"] = lin(
            27 + w if i == 0 else w // 2, w // 2)
    sd["final_linear.weight"], sd["final_linear.bias"] = lin(w // 2, 1)
    sd_torch = {k: torch.from_numpy(v) for k, v in sd.items()}
    for ours_fn, theirs_fn in (
            (port.position_mlp_params_from_torch_state,
             j_port.position_mlp_params_from_torch_state),
            (port.position_direction_mlp_params_from_torch_state,
             j_port.position_direction_mlp_params_from_torch_state)):
        theirs = _np(theirs_fn(sd, depth))
        for src in (sd, sd_torch):
            ours = ours_fn(src, depth, device="cpu")
            assert (jax.tree.structure(jax.tree.map(lambda x: 0, ours))
                    == jax.tree.structure(jax.tree.map(lambda x: 0, theirs)))
            for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
                np.testing.assert_array_equal(a.numpy(), b)
    # field_params_from_numpy carries the aux trees and the env map unchanged
    tree = {"normal_mlp": theirs, "env_map": {"emission": np.ones((4, 2, 3), np.float32)}}
    conv = field_params_from_numpy(tree, "cpu")
    for a, b in zip(jax.tree.leaves(conv), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


# --- the environment map ------------------------------------------------------------

def test_envmap_init_and_lookup_match_jax():
    ours = envmap.init_envmap(np.random.default_rng(0), n=8, device="cpu")
    theirs = j_envmap.init_envmap(jax.random.key(0), n=8)
    assert ours["emission"].shape == theirs["emission"].shape == (16, 8, 3)
    assert ours["emission"].dtype == torch.float32
    assert 0.0 <= float(ours["emission"].min()) and float(ours["emission"].max()) < 0.1

    rng = np.random.default_rng(1)
    dirs = np.concatenate([np.eye(3), -np.eye(3), rng.standard_normal((58, 3)) * 2.0])
    dirs = dirs.astype(np.float32)
    ref = j_envmap.sample_envmap(theirs, jnp.asarray(dirs))
    p = {"emission": _t(theirs["emission"]).requires_grad_(True)}
    out = envmap.sample_envmap(p, _t(dirs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(
        envmap.direction_to_canonical(_t(dirs)).numpy(),
        np.asarray(j_envmap.direction_to_canonical(jnp.asarray(dirs))), atol=1e-6)

    w = rng.standard_normal((64, 3)).astype(np.float32)
    jg = jax.grad(lambda pp: jnp.sum(j_envmap.sample_envmap(pp, jnp.asarray(dirs)) * w))(theirs)
    (g,) = torch.autograd.grad(torch.sum(out * _t(w)), [p["emission"]])
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["emission"]), atol=1e-5)
    assert float(g.abs().sum()) > 0


# --- render_rays with the aux heads -----------------------------------------------

def _cfgs(field=FIELD, **kw):
    base = dict(n_samples=8, n_importance=8, perturb=False, approximate_radiance=True,
                normal_type="ground_truth", correct_depth_for_prefiltered_radiance_infer=True,
                compute_dtype="float32")
    jr = JRenderConfig(field=JFieldConfig(**field), **base).replace(**kw)
    fields = {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)}
    fields["field"] = FieldConfig(**dataclasses.asdict(fields["field"]))
    return jr, RenderConfig(**fields)


def _aux_variables(key, field):
    """JAX fields (visible density) and every aux head, 8 x `width`, as
    JAX's and as the port's params."""
    jcfg = JFieldConfig(**field)
    ks = iter(jax.random.split(key, 8))
    w, in_ch = field["width"], jcfg.input_ch
    jv = {"coarse": j_init(next(ks), jcfg), "fine": j_init(next(ks), jcfg),
          "depth_mlp": j_aux.init_position_direction_mlp(next(ks), 8, w, in_ch,
                                                         jcfg.input_ch_views, 1)}
    for name, out_ch in AUX_HEADS.items():
        jv[name] = j_aux.init_position_mlp(next(ks), 8, w, in_ch, out_ch)
    for name in ("coarse", "fine"):
        jv[name]["sigma"]["b"] = jv[name]["sigma"]["b"] + 0.5
    # a positive inferred depth, so its relu passes a gradient
    jv["depth_mlp"]["out"]["b"] = jv["depth_mlp"]["out"]["b"] + 3.0
    return jv, field_params_from_numpy(_np(jv), "cpu")


@pytest.fixture(scope="module")
def setup():
    jv, tv = _aux_variables(jax.random.key(7), FIELD)
    rng = np.random.default_rng(3)
    rays_o = (rng.standard_normal((B, 3)) * 0.1).astype(np.float32)
    rays_d = rng.standard_normal((B, 3)).astype(np.float32)
    gt = {"normal": rng.uniform(0, 1, (B, 3)).astype(np.float32)}
    return (jv, tv, {"brdf_lut": jnp.asarray(j_load_lut())},
            {"brdf_lut": load_brdf_lut(device="cpu")}, rays_o, rays_d, gt)


AUX_MODES = {
    "infer_normal": dict(infer_normal=True),
    "infer_normal_at_surface": dict(infer_normal=True, infer_normal_at_surface=True),
    "inferred_normal_map": dict(infer_normal=True, normal_type="inferred_normal_map"),
    "inferred_normal_map_at_surface": dict(infer_normal=True, infer_normal_at_surface=True,
                                           normal_type="inferred_normal_map"),
    "infer_depth": dict(infer_depth=True),
    "infer_albedo_separate": dict(infer_albedo_separate=True),
    "infer_roughness_separate": dict(infer_roughness_separate=True),
    "infer_irradiance_separate": dict(infer_irradiance_separate=True),
}


def _render_both(setup, jr, tr, is_depth_only=False):
    jv, tv, jc, tc, rays_o, rays_d, gt = setup
    ref = jax.jit(lambda b, g: j_render_rays(jax.random.key(0), jv, jc, b, jr, gt_values=g,
                                             is_depth_only=is_depth_only))(
        j_batch(jnp.asarray(rays_o), jnp.asarray(rays_d), 2.0, 6.0),
        {k: jnp.asarray(v) for k, v in gt.items()})
    out = render_rays(tv, tc, make_ray_batch(_t(rays_o), _t(rays_d), 2.0, 6.0), tr,
                      is_depth_only=is_depth_only, gt_values={k: _t(v) for k, v in gt.items()})
    assert set(out) == set(ref)
    for k, r in ref.items():
        atol, rtol = SHADED_TOL if k.rstrip("0") in SHADED else BASIC_TOL
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(r), atol=atol,
                                   rtol=rtol, err_msg=k)
    return out


@pytest.mark.parametrize("mode", list(AUX_MODES))
def test_render_rays_aux_heads_match_jax(setup, mode):
    out = _render_both(setup, *_cfgs(**AUX_MODES[mode]))
    if mode.startswith("inferred_normal_map"):
        # the inferred normal shades as it is: 2 sigmoid - 1, not normalised
        np.testing.assert_array_equal(out["target_normal_map"].detach().numpy(),
                                      out["inferred_normal_map"].detach().numpy())
        norms = np.linalg.norm(out["inferred_normal_map"].detach().numpy(), axis=-1)
        assert np.abs(norms - 1.0).max() > 1e-2
    if "normal" in mode:
        assert out["inferred_normal_map0"].shape == (B, 3)
    if mode == "infer_depth":
        assert out["inferred_depth_map"].shape == (B,)
        assert "inferred_depth_map0" not in out


def test_depth_only_pass_infers_depth_like_jax(setup):
    out = _render_both(setup, *_cfgs(infer_depth=True), is_depth_only=True)
    assert {"inferred_depth_map", "depth_map", "depth_map0"} <= set(out)


def test_inferred_normal_map_needs_infer_normal(setup):
    _, tv, _, tc, rays_o, rays_d, _ = setup
    with pytest.raises(ValueError, match="infer_normal"):
        render_rays(tv, tc, make_ray_batch(_t(rays_o), _t(rays_d), 2.0, 6.0),
                    _cfgs(normal_type="inferred_normal_map")[1])


# --- one train step with the inferred normal and depth and the volume pass --------

H, W, N_IMAGES, S, SI = 12, 16, 3, 8, 8
BT, N_VOL = 16, 8
NEAR, FAR = 2.0, 6.0
LOSS = dict(infer_normal=True, infer_depth=True, n_iter_ignore_normal=0, n_iter_ignore_depth=0,
            n_iter_ignore_approximated_radiance=0, beta_inferred_depth=1.0)
LOSS_TOL, GRAD_TOL = 1e-4, 2e-4


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    poses = np.stack([np.eye(4, dtype=np.float32)] * N_IMAGES)
    poses[:, 2, 3] = np.linspace(3, 4, N_IMAGES)
    poses[:, 0, 3] = np.linspace(-0.2, 0.2, N_IMAGES)
    arrays = {"images": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "prefiltered_images": rng.uniform(0, 1, (3, N_IMAGES, H, W, 3)),
              "normal": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "poses": poses,
              "K": np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]])}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: _t(v) for k, v in arrays.items()})


def _step_draws(key):
    """JAX's draws of make_train_step's loss_fn for `key`, merged, with
    the depth-volume pass's: its directions from k_vol, its render's
    uniforms from k_vol_render."""
    k_sample, k_render, k_vol, k_vol_render, _ = jax.random.split(key, 5)
    k_img, k_u, k_v = jax.random.split(k_sample, 3)

    def render(k, n):
        k_strat, _, k_pdf, _ = jax.random.split(k, 4)
        return {"strat": _t(jax.random.uniform(k_strat, (n, S))),
                "pdf": _t(jax.random.uniform(k_pdf, (n, SI)))}

    return {"pixels": {"img": _t(jax.random.randint(k_img, (BT,), 0, N_IMAGES)).long(),
                       "u": _t(jax.random.randint(k_u, (BT,), 0, W)).long(),
                       "v": _t(jax.random.randint(k_v, (BT,), 0, H)).long()},
            "render": render(k_render, BT),
            "vol": {"dirs": _t(jax.random.uniform(k_vol, (BT, 3))),
                    "render": render(k_vol_render, N_VOL)}}


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in leaves])


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_aux_train_step_with_depth_volume_matches_jax(scene):
    jarr, tarr = scene
    field = dict(FIELD, multires=4)
    jr, tr = _cfgs(field=field, n_samples=S, n_importance=SI, perturb=True,
                   infer_normal=True, infer_depth=True)
    jl, tl = jlosses.LossConfig(**LOSS), tlosses.LossConfig(**LOSS)
    jph, tph = jlosses.resolve_phase(100, jl), tlosses.resolve_phase(100, tl)
    assert jph.depth_loss_on and jph.normal_loss_on
    jv, tv = _aux_variables(jax.random.key(0), field)
    del jv["albedo_mlp"], jv["roughness_mlp"], jv["irradiance_mlp"]
    tv = {k: v for k, v in tv.items() if k in jv}
    jc, tc = {"brdf_lut": jnp.asarray(j_load_lut())}, {"brdf_lut": load_brdf_lut(device="cpu")}
    key = jax.random.key(5)
    rcfg = jstep.phase_render_config(jr, jph)

    def loss_fn(variables):  # make_train_step's loss_fn, merged
        k_sample, k_render, k_vol, k_vol_render, _ = jax.random.split(key, 5)
        pixel_info, rays_o, rays_d, *_ = j_sample(k_sample, jarr, BT, H, W, merged=True)
        return jstep.loss_from_batch(variables, (k_render, k_vol, k_vol_render), jc,
                                     pixel_info, rays_o, rays_d, rcfg, jl, jph, 0.7,
                                     NEAR, FAR, N_VOL)

    (jloss, jsc), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jv)
    jopt = jstep.build_optimizer(jv, lrate=5e-4, lrate_decay=500, lcfg=jl)
    jfn = jstep.make_train_step(jr, jl, jph, jopt, jc, H, W, BT, 0.7, NEAR, FAR,
                                merged_sampling=True, n_depth_random_volume=N_VOL,
                                donate=False)
    jstate, jscalars = jfn(jstep.init_train_state(jv, jopt), key, jarr)

    opt = tstep.build_optimizer(tv, lrate=5e-4, lrate_decay=500, lcfg=tl)
    state = tstep.init_train_state(tv, opt)
    step = tstep.make_train_step(tr, tl, tph, opt, tc, H, W, BT, 0.7, NEAR, FAR,
                                 merged_sampling=True, n_depth_random_volume=N_VOL)
    assert set(step.draw(tarr)) == {"pixels", "render", "vol"}
    assert step.draw(tarr)["vol"]["dirs"].shape == (N_VOL, 3)
    draws = _step_draws(key)
    loss, scalars, grads = step.loss_and_grads(state.variables, tarr, draws)
    for ref in (float(jloss), float(jscalars["loss_total"])):
        assert abs(float(loss) - ref) <= LOSS_TOL * abs(ref)
    for name in ("loss_inferred_normal", "loss_depth", "loss_render", "loss_radiance"):
        assert float(jsc[name]) > 0, name
        assert abs(float(scalars[name]) - float(jsc[name])) <= LOSS_TOL * float(jsc[name]), name
    for group in jv:
        got = _flat([g.numpy() for g in tstep._leaves(grads[group])])
        assert _rel(got, _flat(jax.tree.leaves(jgrads[group]))) < GRAD_TOL, group

    state, _ = step(state, tarr, draws=draws)
    for group in jv:
        got = _flat([p.detach().numpy() for p in tstep._leaves(state.variables[group])])
        start = _flat(jax.tree.leaves(jv[group]))
        ref = _flat(jax.tree.leaves(jstate.variables[group]))
        assert _rel(got - start, ref - start) < 2e-2, group


# --- the trainer -----------------------------------------------------------------------

AUX_FLAGS = ("--infer_normal", "--infer_depth", "--infer_albedo_separate",
             "--infer_roughness_separate", "--infer_irradiance_separate", "--infer_visibility",
             "--use_environment_map")


def test_init_variables_have_jax_keys_and_shapes():
    argv = ["--netwidth", "32", "--N_importance", "8", "--N_envmap_size", "8", *AUX_FLAGS]
    targs, jargs = parse_with_includes(argv), j_parse(argv)
    ours = loop.init_variables(0, targs, loop.field_config_from_args(targs), "cpu")
    theirs = j_loop.init_variables(jax.random.key(0), jargs, j_loop.field_config_from_args(jargs))
    assert list(ours) == list(theirs) == [
        "coarse", "fine", "depth_mlp", "visibility_mlp", "normal_mlp", "albedo_mlp",
        "roughness_mlp", "irradiance_mlp", "env_map"]
    for name in theirs:
        assert (jax.tree.structure(jax.tree.map(lambda x: 0, ours[name]))
                == jax.tree.structure(jax.tree.map(lambda x: 0, theirs[name]))), name
        assert ([tuple(x.shape) for x in jax.tree.leaves(ours[name])]
                == [tuple(x.shape) for x in jax.tree.leaves(theirs[name])]), name


def test_aux_train_checkpoints_hold_jax_groups(tmp_path):
    """Updates 0..5 with every aux flag, gt normals, the phase switch and
    both aux losses at update 2, a checkpoint after every update."""
    scene_dir = make_scene(str(tmp_path / "scene"))
    argv = ["--datadir", scene_dir, "--basedir", str(tmp_path / "logs"), "--expname", "exp",
            "--netdepth", "4", "--netwidth", "16", "--N_rand", "16", "--N_samples", "8",
            "--N_importance", "8", "--N_iter", "5", "--coarse_radiance_number", "2",
            "--load_depth_range_from_file", "--N_iter_ignore_approximated_radiance", "2",
            "--N_iter_ignore_normal", "2", "--N_iter_ignore_depth", "2",
            "--N_depth_random_volume", "8", "--N_envmap_size", "4",
            "--i_weights", "1", "--i_testset", "100", "--summary_step", "1",
            "--compute_dtype", "float32", *AUX_FLAGS]
    args = parse_with_includes(argv)
    state = loop.train(args, device="cpu")
    assert state.step == 6
    init = loop.init_variables(0, args, loop.field_config_from_args(args), "cpu")
    jargs = j_parse(argv)
    j_keys = list(j_loop.init_variables(jax.random.key(0), jargs,
                                        j_loop.field_config_from_args(jargs)))
    logdir = os.path.join(str(tmp_path / "logs"), "exp")
    ckpts = {}
    for i in range(6):
        payload = torch.load(os.path.join(logdir, f"ckpt_{i:06d}", ckpt_lib.STATE_FILE),
                             weights_only=True)
        assert set(payload["variables"]) == set(payload["opt_state"]) == set(j_keys)
        ckpts[i] = payload["variables"]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tstep._leaves(a), tstep._leaves(b)))

    for name in ("normal_mlp", "depth_mlp", "albedo_mlp", "roughness_mlp", "irradiance_mlp"):
        assert same(ckpts[1][name], init[name]), name        # before update 2
        assert not same(ckpts[2][name], init[name]), name    # from update 2 on
        assert not same(ckpts[5][name], ckpts[3][name]), name
    for name in ("visibility_mlp", "env_map"):
        assert same(ckpts[5][name], init[name]), name
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    by_step = {r["step"]: r for r in records}
    for i in range(6):
        for k in ("loss_inferred_normal", "loss_depth"):
            assert (by_step[i][k] > 0) == (i >= 2), (i, k)
            assert np.isfinite(by_step[i][k])
