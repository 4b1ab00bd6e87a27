"""Patch sampling, raw-σ noise and a ported init, the port against JAX.

- `neighbor_coords` bit for bit, `ndc_rays` and the patch rays within
  1e-6, and `sample_pixel_batch(patch=True)` on JAX's draws: the same
  gathers bit for bit.
- `render_rays` with `raw_noise_std=1.0`, JAX's noise (standard normals
  from k_coarse and k_fine, split once more in a shading pass) handed to
  the port: within 5e-4 on the basic maps and 2e-3 on the shaded ones.
- A patch step with noise against JAX's `make_train_step(patch=True)`:
  the loss within 1e-4, every group's gradient within 2e-4, and
  `patch_depth_smoothness` within 1e-5 relative.
- `--init_port_path` through `train(..., device="cpu")`: the ported
  fields arrive bit for bit, a dead one is kept (its σ bias still below
  -99 after an update), and no init is re-drawn.

Depth 8, width 32, 16 rays, 8 + 8 samples.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_lut
from ibl_nerf_tpu.data.sampler import sample_pixel_batch as j_sample
from ibl_nerf_tpu.models.field import FieldConfig as JFieldConfig
from ibl_nerf_tpu.models.field import init_field_params as j_init
from ibl_nerf_tpu.ops import rays as jrays
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.render import make_ray_batch as j_batch
from ibl_nerf_tpu.render import render_rays as j_render_rays
from ibl_nerf_tpu.train import losses as jlosses
from ibl_nerf_tpu.train import step as jstep
from ibl_nerf_tpu_torch.cli.config import parse_with_includes
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.data.sampler import pixel_bounds, sample_pixel_batch
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.ops import rays as trays
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.train import health, loop
from ibl_nerf_tpu_torch.train import losses as tlosses
from ibl_nerf_tpu_torch.train import step as tstep
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_scene import make_scene  # noqa: E402

torch.set_num_threads(2)

B, H, W, N_IMAGES, S, SI = 16, 12, 16, 3, 8, 8
NEAR, FAR = 2.0, 6.0
EPS = "normal_map_from_depth_gradient_epsilon"
BASIC_TOL, SHADED_TOL = (5e-4, 1e-3), (2e-3, 5e-3)
SHADED = {"color_map", "specular_map", "diffuse_map", "n_dot_v_map", "target_normal_map",
          EPS, "normal_map_from_depth_gradient_direction_epsilon",
          "reflected_radiance_map", "prefiltered_reflected_map"}
LOSS = dict(load_priors=True, freeze_roughness=True,
            n_iter_ignore_approximated_radiance=10000, n_iter_ignore_prior=100000,
            beta_prior_albedo=1.0, beta_irradiance_reg=0.1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    poses = np.stack([np.eye(4, dtype=np.float32)] * N_IMAGES)
    poses[:, :3, 3] = rng.standard_normal((N_IMAGES, 3)) * 0.2 + [0, 0, 3.5]
    arrays = {"images": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "prefiltered_images": rng.uniform(0, 1, (3, N_IMAGES, H, W, 3)),
              "normal": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "prior_albedo": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "prior_irradiance": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "poses": poses,
              "K": np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]])}
    return {k: v.astype(np.float32) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def scene():
    arrays = _arrays()
    return ({k: jnp.asarray(v) for k, v in arrays.items()}, {k: _t(v) for k, v in arrays.items()},
            {"brdf_lut": jnp.asarray(j_lut())}, {"brdf_lut": load_brdf_lut(device="cpu")})


# --- rays and the patch batch ----------------------------------------------------------

def test_neighbor_coords_bit_exact():
    uv = np.random.default_rng(0).integers(1, 30, (64, 2)).astype(np.int32)
    ref = np.asarray(jrays.neighbor_coords(jnp.asarray(uv)))
    for dtype in (torch.int32, torch.int64):
        out = trays.neighbor_coords(torch.from_numpy(uv).to(dtype))
        assert out.shape == (64, 8, 2) and out.dtype == dtype
        np.testing.assert_array_equal(out.numpy(), ref)


def test_ndc_and_patch_rays_match_jax():
    rng = np.random.default_rng(1)
    rays_o = (rng.standard_normal((32, 3)) * 0.3).astype(np.float32)
    rays_d = rng.standard_normal((32, 3)).astype(np.float32)
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 0.5  # forward-facing
    ref = jrays.ndc_rays(48, 64, 40.0, 1.0, jnp.asarray(rays_o), jnp.asarray(rays_d))
    out = trays.ndc_rays(48, 64, 40.0, 1.0, _t(rays_o), _t(rays_d))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6, rtol=1e-6)

    uv = rng.integers(1, 40, (16, 8, 2)).astype(np.float32)
    K = np.array([[30.0, 0, 32], [0, 30.0, 24], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = [0.1, -0.2, 3.0]
    ref = jrays.get_rays_for_patches(jnp.asarray(uv), jnp.asarray(K), jnp.asarray(c2w))
    out = trays.get_rays_for_patches(_t(uv), _t(K), _t(c2w))
    for o, r in zip(out, ref):
        assert o.shape == (16, 8, 3)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def _pixel_draws(key, patch=True, precrop=False, n_images=N_IMAGES, b=B, h=H, w=W):
    """JAX's sample_pixel_batch draws for `key` (single image)."""
    k_img, k_u, k_v = jax.random.split(key, 3)
    sh, eh, sw, ew = pixel_bounds(h, w, precrop, 0.5, patch)
    return {"img": _t(jax.random.randint(k_img, (), 0, n_images)).long(),
            "u": _t(jax.random.randint(k_u, (b,), sw, ew)).long(),
            "v": _t(jax.random.randint(k_v, (b,), sh, eh)).long()}


@pytest.mark.parametrize("precrop", [False, True], ids=["patch", "precrop-wins"])
def test_patch_batch_matches_jax(scene, precrop):
    jarr, tarr, _, _ = scene
    key = jax.random.key(4)
    ref = j_sample(key, jarr, B, H, W, precrop=precrop, patch=True)
    draws = _pixel_draws(key, precrop=precrop)
    out = sample_pixel_batch(tarr, B, H, W, precrop, 0.5, patch=True, draws=draws)
    if not precrop:  # a neighbour on every side
        assert int(draws["u"].min()) >= 1 and int(draws["u"].max()) <= W - 2
    for got, want in ((out[0], ref[0]), (out[3], ref[3])):  # pixel and neighbour gathers
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert set(out[3]) == {"rgb", "normal"} and out[3]["rgb"].shape == (B, 8, 3)
    for i in (1, 2, 4, 5):
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]), atol=1e-6)


# --- raw-σ noise in render_rays --------------------------------------------------------

def _cfgs(**kw):
    field = dict(depth=8, width=32, coarse_radiance_number=3, multires=4)
    base = dict(n_samples=S, n_importance=SI, perturb=False, approximate_radiance=True,
                normal_type=EPS, correct_depth_for_prefiltered_radiance_infer=True,
                compute_dtype="float32")
    jr = JRenderConfig(field=JFieldConfig(**field), **base).replace(**kw)
    fields = {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)}
    fields["field"] = FieldConfig(**dataclasses.asdict(fields["field"]))
    return jr, RenderConfig(**fields)


def _variables(seed=0):
    cfg = JFieldConfig(depth=8, width=32, coarse_radiance_number=3, multires=4)
    k1, k2 = jax.random.split(jax.random.key(seed))
    jv = {"coarse": j_init(k1, cfg), "fine": j_init(k2, cfg)}
    for v in jv.values():  # visible density, so depth and normals mean something
        v["sigma"]["b"] = v["sigma"]["b"] + 0.5
    return jv, field_params_from_numpy(jax.tree.map(np.asarray, jv), "cpu")


def render_draws(key, n, rcfg, is_depth_only=False):
    """JAX's draws of render_rays(key) for n rays: the perturb uniforms
    from k_strat and k_pdf, the noise from k_coarse and k_fine (split
    once more in a shading pass)."""
    k_strat, k_coarse, k_pdf, k_fine = jax.random.split(key, 4)
    coarse_depth_only = is_depth_only or not rcfg.coarse_shading

    def normals(k, depth_only, m):
        k = k if depth_only else jax.random.split(k)[0]
        return _t(jax.random.normal(k, (n, m)))

    out = {"noise_coarse": normals(k_coarse, coarse_depth_only, S),
           "noise_fine": normals(k_fine, is_depth_only, S + SI)}
    if rcfg.perturb:
        out.update(strat=_t(jax.random.uniform(k_strat, (n, S))),
                   pdf=_t(jax.random.uniform(k_pdf, (n, SI))))
    return out


NOISE_MODES = {
    "shading": dict(),
    "shading-perturb": dict(perturb=True),
    "fast-coarse": dict(coarse_shading=False),
    "depth-only": dict(perturb=True),
    "bf16-k1": dict(compute_dtype="bf16_grad", use_pallas=True, use_pallas_train=True),
}


@pytest.mark.parametrize("mode", list(NOISE_MODES))
def test_render_rays_with_raw_noise_match_jax(scene, mode):
    _, _, jc, tc = scene
    jr, tr = _cfgs(raw_noise_std=1.0, **NOISE_MODES[mode])
    jv, tv = _variables()
    rng = np.random.default_rng(3)
    rays_o = (rng.standard_normal((B, 3)) * 0.1).astype(np.float32)
    rays_d = rng.standard_normal((B, 3)).astype(np.float32)
    depth_only = mode == "depth-only"
    key = jax.random.key(2)
    ref = jax.jit(lambda b: j_render_rays(key, jv, jc, b, jr, is_depth_only=depth_only))(
        j_batch(jnp.asarray(rays_o), jnp.asarray(rays_d), NEAR, FAR))
    draws = render_draws(key, B, tr, depth_only)
    out = render_rays(tv, tc, make_ray_batch(_t(rays_o), _t(rays_d), NEAR, FAR), tr,
                      is_depth_only=depth_only, draws=draws)
    assert set(out) == set(ref)
    bf16 = mode == "bf16-k1"
    for k, r in ref.items():
        atol, rtol = SHADED_TOL if (k.rstrip("0") in SHADED or bf16) else BASIC_TOL
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(r), atol=atol,
                                   rtol=rtol, err_msg=k)
    # the noise reaches the maps: without it the depth moves
    quiet = render_rays(tv, tc, make_ray_batch(_t(rays_o), _t(rays_d), NEAR, FAR),
                        tr.replace(raw_noise_std=0.0), is_depth_only=depth_only,
                        draws={k: v for k, v in draws.items() if not k.startswith("noise")})
    assert np.abs(quiet["depth_map"].detach().numpy() - out["depth_map"].detach().numpy()
                  ).max() > 1e-3


def test_noise_draws_without_perturb():
    """raw_noise_std draws standard normals also with perturb off, in the
    rays' dtype, and no uniforms."""
    _, tr = _cfgs(raw_noise_std=0.5)
    from ibl_nerf_tpu_torch.render.renderer import draw_render_uniforms

    d = draw_render_uniforms(5, tr, "cpu", torch.Generator().manual_seed(0))
    assert set(d) == {"noise_coarse", "noise_fine"}
    assert d["noise_coarse"].shape == (5, S) and d["noise_fine"].shape == (5, S + SI)
    assert abs(float(d["noise_fine"].mean())) < 1.0 and float(d["noise_fine"].std()) > 0.5
    assert draw_render_uniforms(5, tr.replace(raw_noise_std=0.0), "cpu") == {}


# --- a patch step with noise -------------------------------------------------------------

def _step_draws(key, rcfg):
    """JAX's draws of make_train_step(patch=True)'s loss_fn for `key`."""
    k_sample, k_render, _, _, k_patch = jax.random.split(key, 5)
    return {"pixels": _pixel_draws(k_sample), "render": render_draws(k_render, B, rcfg),
            "patch": render_draws(k_patch, 8 * B, rcfg, is_depth_only=True)}


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in leaves])


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_patch_step_with_noise_matches_jax(scene):
    jarr, tarr, jc, tc = scene
    jr, tr = _cfgs(perturb=True, raw_noise_std=1.0)
    jl, tl = jlosses.LossConfig(**LOSS), tlosses.LossConfig(**LOSS)
    jph, tph = jlosses.resolve_phase(50000, jl), tlosses.resolve_phase(50000, tl)
    jv, tv = _variables()
    key = jax.random.key(5)
    rcfg = jstep.phase_render_config(jr, jph)

    def loss_fn(variables):  # make_train_step's loss_fn without the no-grad patch pass
        k_sample, k_render, k_vol, k_vol_render, _ = jax.random.split(key, 5)
        pixel_info, rays_o, rays_d, *_ = j_sample(k_sample, jarr, B, H, W, patch=True)
        return jstep.loss_from_batch(variables, (k_render, k_vol, k_vol_render), jc,
                                     pixel_info, rays_o, rays_d, rcfg, jl, jph, 0.7,
                                     NEAR, FAR, B)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jv)
    jopt = jstep.build_optimizer(jv, lrate=5e-4, lrate_decay=500, lcfg=jl)
    jfn = jstep.make_train_step(jr, jl, jph, jopt, jc, H, W, B, 0.7, NEAR, FAR,
                                donate=False, patch=True)
    _, jscalars = jfn(jstep.init_train_state(jv, jopt), key, jarr)

    opt = tstep.build_optimizer(tv, lrate=5e-4, lrate_decay=500, lcfg=tl)
    step = tstep.make_train_step(tr, tl, tph, opt, tc, H, W, B, 0.7, NEAR, FAR, patch=True)
    drawn = step.draw(tarr, torch.Generator().manual_seed(0))
    assert set(drawn) == {"pixels", "render", "patch"}
    assert drawn["patch"]["noise_fine"].shape == (8 * B, S + SI)
    state = tstep.init_train_state(tv, opt)
    loss, scalars, grads = step.loss_and_grads(state.variables, tarr, _step_draws(key, tr))
    for ref in (float(jloss), float(jscalars["loss_total"])):
        assert abs(float(loss) - ref) <= 1e-4 * abs(ref)
    smooth, ref = float(scalars["patch_depth_smoothness"]), float(
        jscalars["patch_depth_smoothness"])
    assert ref > 0 and abs(smooth - ref) <= 1e-5 * ref
    for group in ("coarse", "fine"):
        got = _flat([g.numpy() for g in tstep._leaves(grads[group])])
        assert _rel(got, _flat(jax.tree.leaves(jgrads[group]))) < 2e-4, group


def test_patch_smoothness_uses_the_population_std():
    """ddof 0, as jnp.std: the mean of std(correction=0) over the pixels'
    8 neighbour depths (a constant depth field gives 0)."""
    _, tr = _cfgs()
    rays_o = torch.zeros(2, 8, 3)
    rays_d = torch.tensor([0.0, 0.0, -1.0]).expand(2, 8, 3)
    _, tv = _variables()
    out = tstep.patch_depth_smoothness(tv, {"brdf_lut": load_brdf_lut(device="cpu")},
                                       rays_o, rays_d, tr, NEAR, FAR)
    assert float(out) == 0.0


# --- --init_port_path ------------------------------------------------------------------

def _argv(scene_dir, logdir, *extra):
    return ["--datadir", scene_dir, "--basedir", logdir, "--expname", "exp",
            "--netdepth", "4", "--netwidth", "16", "--N_rand", "16", "--N_samples", "8",
            "--N_importance", "8", "--N_iter", "0", "--coarse_radiance_number", "2",
            "--load_depth_range_from_file", "--i_weights", "100", "--i_testset", "100",
            "--summary_step", "1", "--testskip", "1", *extra]


def _reference_state_dict(params, depth):
    """A port field's params under the reference's key names, Linear
    weights (out, in)."""
    names = {"sigma": "sigma_linear", "albedo_feat": "albedo_feature_linear",
             "albedo": "albedo_linear", "roughness": "roughness_linear",
             "irradiance_feat": "irradiance_feature_linear", "irradiance": "irradiance_linear",
             "feature": "feature_linear", "radiance": "radiance_linear"}
    lin = {f"positions_linears.{i}": params["trunk"][i] for i in range(depth)}
    lin.update({v: params[k] for k, v in names.items()})
    lin["views_linears.0"] = params["views"][0]
    for i in range(len(params["coarse"])):
        lin[f"additional_radiance_feature_linear.{i}"] = params["coarse_feat"][i]
        lin[f"additional_radiance_linear.{i}"] = params["coarse"][i]
    sd = {}
    for name, q in lin.items():
        sd[f"{name}.weight"] = q["w"].T.contiguous().clone()
        sd[f"{name}.bias"] = q["b"].clone()
    return sd


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene")))


def test_init_port_path_is_never_redrawn(scene_dir, tmp_path, monkeypatch):
    cfg = FieldConfig(depth=4, width=16, coarse_radiance_number=2)
    rng = np.random.default_rng(11)
    coarse, fine = init_field_params(rng, cfg, "cpu"), init_field_params(rng, cfg, "cpu")
    coarse["sigma"]["b"] += 0.5  # alive
    fine["sigma"]["b"] -= 100.0  # dead
    tar = str(tmp_path / "ref.tar")
    torch.save({"network_fn_state_dict": _reference_state_dict(coarse, 4),
                "network_fine_state_dict": _reference_state_dict(fine, 4),
                "global_step": 0}, tar)

    seen = {}
    build = loop.build_optimizer

    def spy(variables, *a, **kw):
        seen.update(variables)
        return build(variables, *a, **kw)

    def no_rejection(*a, **kw):
        raise AssertionError("a ported init went through dead-init rejection")

    monkeypatch.setattr(loop, "build_optimizer", spy)
    monkeypatch.setattr(health, "reject_dead_inits", no_rejection)
    errors = []
    monkeypatch.setattr(loop.load_logger("train"), "error",
                        lambda msg, *a: errors.append(msg % a))
    state = loop.train(parse_with_includes(_argv(scene_dir, str(tmp_path / "run"),
                                                 "--init_port_path", tar)), device="cpu")
    for name, want in (("coarse", coarse), ("fine", fine)):
        for got, ref in zip(tstep._leaves(seen[name]), tstep._leaves(want)):
            assert torch.equal(got, ref), name
    assert any("fine field init is DEAD" in e for e in errors), errors
    assert not any("coarse" in e for e in errors), errors
    assert state.step == 1
    assert float(state.variables["fine"]["sigma"]["b"].detach().max()) < -99.0
    assert not torch.equal(state.variables["coarse"]["sigma"]["w"], coarse["sigma"]["w"])
