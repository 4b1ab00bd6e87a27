"""The gt inputs of the port's renderer and train step against JAX's.

`render_rays` with `gt_values` on both sides: the `ground_truth` normal
(the gt normal map, stored as (n + 1) / 2), and each of the four gt
substitutions (`depth_map_from_ground_truth`, which moves the surface
point of the reflected march, and `calculate_{albedo,roughness,
irradiance}_from_gt`), in float32 and in bf16_grad with K1 on the
no-grad sweeps (the plain K1 here, JAX's Pallas kernel in interpret
mode). Depth 8, width 32, 8 rays, 8 + 8 samples, coarse shading on.
Tolerances of tests/test_renderer_parity.py: atol 5e-4 / rtol 1e-3 on
the basic maps, 2e-3 / 5e-3 on the shaded ones; with gt normals no map
is a finite difference, so bf16_grad's primary march holds them too.

Then one merged-sampling train step (an image per ray) with gt normals
in float32, the draws made by jax.random and passed in, against JAX's
`make_train_step`: the loss and each parameter group's gradient within
the bounds of tests/test_torch_train_step.py (which holds the K2/K3
step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_load_lut
from ibl_nerf_tpu.data.sampler import sample_pixel_batch as j_sample
from ibl_nerf_tpu.models.field import FieldConfig as JFieldConfig
from ibl_nerf_tpu.models.field import init_field_params as j_init
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.render import make_ray_batch as j_batch
from ibl_nerf_tpu.render import render_rays as j_render_rays
from ibl_nerf_tpu.train import losses as jlosses
from ibl_nerf_tpu.train import step as jstep
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.data.sampler import sample_pixel_batch
from ibl_nerf_tpu_torch.models.field import FieldConfig
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.train import losses as tlosses
from ibl_nerf_tpu_torch.train import step as tstep
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

torch.set_num_threads(2)

FIELD = dict(depth=8, width=32, coarse_radiance_number=3)
BASE = dict(n_samples=8, n_importance=8, perturb=False, approximate_radiance=True,
            normal_type="ground_truth", correct_depth_for_prefiltered_radiance_infer=True)
SHADED = {"color_map", "specular_map", "diffuse_map", "n_dot_v_map", "target_normal_map",
          "reflected_radiance_map", "prefiltered_reflected_map"}
BASIC_TOL, SHADED_TOL = (5e-4, 1e-3), (2e-3, 5e-3)
B = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(field=FIELD, base=BASE, **kw):
    jr = JRenderConfig(field=JFieldConfig(**field), **base).replace(**kw)
    fields = {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)}
    fields["field"] = FieldConfig(**dataclasses.asdict(fields["field"]))
    return jr, RenderConfig(**fields)


@pytest.fixture(scope="module")
def setup():
    jcfg = JFieldConfig(**FIELD)
    k1, k2 = jax.random.split(jax.random.key(7))
    jvars = {"coarse": j_init(k1, jcfg), "fine": j_init(k2, jcfg)}
    for v in jvars.values():  # visible density, so depth and normals mean something
        v["sigma"]["b"] = v["sigma"]["b"] + 0.5
    tvars = field_params_from_numpy(jax.tree.map(np.asarray, jvars), "cpu")
    rng = np.random.default_rng(3)
    rays_o = (rng.standard_normal((B, 3)) * 0.1).astype(np.float32)
    rays_d = rng.standard_normal((B, 3)).astype(np.float32)
    gt = {"normal": rng.uniform(0, 1, (B, 3)), "depth": rng.uniform(2.5, 5.0, (B, 1)),
          "albedo": rng.uniform(0, 1, (B, 3)), "roughness": rng.uniform(0, 1, (B, 1)),
          "irradiance": rng.uniform(0, 1, (B, 3))}
    gt = {k: v.astype(np.float32) for k, v in gt.items()}
    return (jvars, tvars, {"brdf_lut": jnp.asarray(j_load_lut())},
            {"brdf_lut": load_brdf_lut(device="cpu")}, rays_o, rays_d, gt)


GT_MODES = {
    "normal": {},
    "depth": dict(depth_map_from_ground_truth=True),
    "albedo": dict(calculate_albedo_from_gt=True),
    "roughness": dict(calculate_roughness_from_gt=True),
    "irradiance": dict(calculate_irradiance_from_gt=True),
}
DTYPES = {"float32": dict(compute_dtype="float32"),
          "bf16_grad-k1": dict(compute_dtype="bf16_grad", use_pallas=True)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", sorted(GT_MODES))
def test_render_rays_gt_inputs_match_jax(setup, mode, dtype):
    jvars, tvars, jconsts, tconsts, rays_o, rays_d, gt = setup
    jr, tr = _cfgs(**GT_MODES[mode], **DTYPES[dtype])
    ref = jax.jit(lambda b, g: j_render_rays(jax.random.key(0), jvars, jconsts, b, jr,
                                             gt_values=g))(
        j_batch(jnp.asarray(rays_o), jnp.asarray(rays_d), 2.0, 6.0),
        {k: jnp.asarray(v) for k, v in gt.items()})
    out = render_rays(tvars, tconsts, make_ray_batch(_t(rays_o), _t(rays_d), 2.0, 6.0), tr,
                      gt_values={k: _t(v) for k, v in gt.items()})
    assert set(out) == set(ref)
    for k, r in ref.items():
        atol, rtol = SHADED_TOL if k.rstrip("0") in SHADED else BASIC_TOL
        np.testing.assert_allclose(out[k].numpy(), np.asarray(r), atol=atol, rtol=rtol,
                                   err_msg=k)
    # the substitution reached the maps: the gt value itself, unit normals
    n = 2.0 * gt["normal"] - 1.0
    np.testing.assert_allclose(out["target_normal_map"].numpy(),
                               n / np.linalg.norm(n, axis=-1, keepdims=True), atol=1e-6)
    substituted = {"depth": ("target_depth_map", gt["depth"][:, 0]),
                   "albedo": ("albedo_map", gt["albedo"]),
                   "roughness": ("roughness_map", gt["roughness"][:, 0]),
                   "irradiance": ("irradiance_map", gt["irradiance"])}
    if mode in substituted:
        key, value = substituted[mode]
        np.testing.assert_array_equal(out[key].numpy(), value)
        np.testing.assert_array_equal(out[key + "0"].numpy(), value)


def test_missing_gt_normal_raises_key_error(setup):
    """As in JAX, a gt mode without its buffer fails on the missing key."""
    _, tvars, _, tconsts, rays_o, rays_d, _ = setup
    with pytest.raises(KeyError, match="normal"):
        render_rays(tvars, tconsts, make_ray_batch(_t(rays_o), _t(rays_d), 2.0, 6.0),
                    _cfgs()[1])


# --- one merged-sampling train step ---------------------------------------------

H, W, N_IMAGES, S, SI = 12, 16, 3, 8, 8
BT = 16
NEAR, FAR = 2.0, 6.0
LOSS = dict(load_priors=True, freeze_roughness=True,
            n_iter_ignore_approximated_radiance=10000, n_iter_ignore_prior=100000,
            beta_prior_albedo=1.0, beta_irradiance_reg=0.1)
# the loss and per-group gradient bounds of tests/test_torch_train_step.py's
# "f32-eps" (gt normals, like ε normals, are f32 on both sides)
LOSS_TOL, GRAD_TOL = 1e-5, 2e-4


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    poses = np.stack([np.eye(4, dtype=np.float32)] * N_IMAGES)
    poses[:, 2, 3] = np.linspace(3, 4, N_IMAGES)
    poses[:, 0, 3] = np.linspace(-0.2, 0.2, N_IMAGES)
    arrays = {"images": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "prefiltered_images": rng.uniform(0, 1, (3, N_IMAGES, H, W, 3)),
              "normal": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "albedo": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "poses": poses,
              "K": np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]])}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: _t(v) for k, v in arrays.items()})


def _step_draws(key):
    """JAX's draws of make_train_step's loss_fn for `key`, merged: the
    image index per ray."""
    k_sample, k_render, _, _, _ = jax.random.split(key, 5)
    k_img, k_u, k_v = jax.random.split(k_sample, 3)
    k_strat, _, k_pdf, _ = jax.random.split(k_render, 4)
    return {"pixels": {"img": _t(jax.random.randint(k_img, (BT,), 0, N_IMAGES)).long(),
                       "u": _t(jax.random.randint(k_u, (BT,), 0, W)).long(),
                       "v": _t(jax.random.randint(k_v, (BT,), 0, H)).long()},
            "render": {"strat": _t(jax.random.uniform(k_strat, (BT, S))),
                       "pdf": _t(jax.random.uniform(k_pdf, (BT, SI)))}}


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in leaves])


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_merged_sampling_matches_jax(scene):
    """The merged batch: every gathered buffer equal, the rays of each
    pixel from its own image's pose."""
    jarr, tarr = scene
    key = jax.random.key(2)
    ref = j_sample(jax.random.split(key, 5)[0], jarr, BT, H, W, merged=True)
    draws = _step_draws(key)["pixels"]
    assert len(set(draws["img"].tolist())) > 1
    pixel, rays_o, rays_d = sample_pixel_batch(tarr, BT, H, W, merged=True, draws=draws)
    assert set(pixel) == set(ref[0])
    for k in pixel:
        np.testing.assert_array_equal(pixel[k].numpy(), np.asarray(ref[0][k]), err_msg=k)
    np.testing.assert_allclose(rays_o.numpy(), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_allclose(rays_d.numpy(), np.asarray(ref[2]), atol=1e-6)


def test_merged_gt_normal_train_step_matches_jax(scene):
    jarr, tarr = scene
    field = dict(FIELD, multires=4)
    base = dict(BASE, n_samples=S, n_importance=SI, perturb=True)
    jr, tr = _cfgs(field=field, base=base, compute_dtype="float32")
    jl, tl = jlosses.LossConfig(**LOSS), tlosses.LossConfig(**LOSS)
    jph, tph = jlosses.resolve_phase(50000, jl), tlosses.resolve_phase(50000, tl)
    cfg = JFieldConfig(**field)
    k1, k2 = jax.random.split(jax.random.key(0))
    jv = {"coarse": j_init(k1, cfg), "fine": j_init(k2, cfg)}
    for v in jv.values():
        v["sigma"]["b"] = v["sigma"]["b"] + 0.5
    tv = field_params_from_numpy(jax.tree.map(np.asarray, jv), "cpu")
    jc, tc = {"brdf_lut": jnp.asarray(j_load_lut())}, {"brdf_lut": load_brdf_lut(device="cpu")}
    key = jax.random.key(5)
    rcfg = jstep.phase_render_config(jr, jph)

    def loss_fn(variables):  # make_train_step's loss_fn, merged
        k_sample, k_render, k_vol, k_vol_render, _ = jax.random.split(key, 5)
        pixel_info, rays_o, rays_d, *_ = j_sample(k_sample, jarr, BT, H, W, merged=True)
        return jstep.loss_from_batch(variables, (k_render, k_vol, k_vol_render), jc,
                                     pixel_info, rays_o, rays_d, rcfg, jl, jph, 0.7,
                                     NEAR, FAR, BT)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jv)
    jopt = jstep.build_optimizer(jv, lrate=5e-4, lrate_decay=500, lcfg=jl)
    jfn = jstep.make_train_step(jr, jl, jph, jopt, jc, H, W, BT, 0.7, NEAR, FAR,
                                merged_sampling=True, donate=False)
    jstate, jscalars = jfn(jstep.init_train_state(jv, jopt), key, jarr)

    opt = tstep.build_optimizer(tv, lrate=5e-4, lrate_decay=500, lcfg=tl)
    state = tstep.init_train_state(tv, opt)
    step = tstep.make_train_step(tr, tl, tph, opt, tc, H, W, BT, 0.7, NEAR, FAR,
                                 merged_sampling=True)
    draws = _step_draws(key)
    loss, scalars, grads = step.loss_and_grads(state.variables, tarr, draws)
    for ref in (float(jloss), float(jscalars["loss_total"])):
        assert abs(float(loss) - ref) <= LOSS_TOL * abs(ref)
    for group in ("coarse", "fine"):
        got = _flat([g.numpy() for g in tstep._leaves(grads[group])])
        assert _rel(got, _flat(jax.tree.leaves(jgrads[group]))) < GRAD_TOL, group

    # the update itself: JAX's make_train_step against the port's step
    state, _ = step(state, tarr, draws=draws)
    got = _flat([p.detach().numpy() for p in tstep._leaves(state.variables)])
    start = _flat(jax.tree.leaves(jv))
    ref = _flat(jax.tree.leaves(jstate.variables))
    assert _rel(got - start, ref - start) < 2e-2
