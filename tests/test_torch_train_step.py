"""The port's train step against JAX's, whole: render with random draws,
losses, gradients and Adam updates.

The draws are reproduced from JAX's key tree (step key -> k_sample ->
k_img, k_u, k_v; k_render -> k_strat, k_pdf) and handed to the port.
Depth 8, width 32, 16 rays, 8 + 8 samples, sgs and ε normals.

The float32 comparisons run at multires 4: the sgs normal is a
derivative of sin(2^k x), and at multires 10 a 1-ulp difference of
sin/cos between XLA and torch (2^9 x reaches hundreds of radians) moves
the normal by ~5e-4, which reaches the roughness gradients through the
mip level; at multires 4 the step is about the algorithm, and every
param group agrees to ~1e-4.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_lut
from ibl_nerf_tpu.data.sampler import sample_pixel_batch as j_sample
from ibl_nerf_tpu.models.field import FieldConfig as JFieldConfig
from ibl_nerf_tpu.models.field import init_field_params as j_init
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.render import make_ray_batch as j_batch
from ibl_nerf_tpu.render import render_rays as j_render_rays
from ibl_nerf_tpu.train import losses as jlosses
from ibl_nerf_tpu.train import step as jstep
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.kernels import fused_field as tff
from ibl_nerf_tpu_torch.models.field import FieldConfig
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.train import losses as tlosses
from ibl_nerf_tpu_torch.train import step as tstep
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

torch.set_num_threads(2)

B, H, W, N_IMAGES, S, SI = 16, 12, 16, 3, 8, 8
NEAR, FAR = 2.0, 6.0
SGS = "normal_map_from_sigma_gradient_surface"
EPS = "normal_map_from_depth_gradient_epsilon"
LOSS = dict(load_priors=True, freeze_roughness=True,
            n_iter_ignore_approximated_radiance=10000, n_iter_ignore_prior=100000,
            beta_prior_albedo=1.0, beta_irradiance_reg=0.1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(multires, **kw):
    field = dict(depth=8, width=32, coarse_radiance_number=3, multires=multires)
    base = dict(n_samples=S, n_importance=SI, perturb=True,
                correct_depth_for_prefiltered_radiance_infer=True, **kw)
    return (JRenderConfig(field=JFieldConfig(**field), **base),
            RenderConfig(field=FieldConfig(**field), **base))


def _variables(multires):
    cfg = JFieldConfig(depth=8, width=32, coarse_radiance_number=3, multires=multires)
    k1, k2 = jax.random.split(jax.random.key(0))
    jv = {"coarse": j_init(k1, cfg), "fine": j_init(k2, cfg)}
    for v in jv.values():  # visible density, so depth and normals mean something
        v["sigma"]["b"] = v["sigma"]["b"] + 0.5
    return jv, field_params_from_numpy(jax.tree.map(np.asarray, jv), "cpu")


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    poses = np.stack([np.eye(4, dtype=np.float32)] * N_IMAGES)
    poses[:, 2, 3] = np.linspace(3, 4, N_IMAGES)
    arrays = {"images": rng.uniform(0, 1, (N_IMAGES, H, W, 3)),
              "prefiltered_images": rng.uniform(0, 1, (3, N_IMAGES, H, W, 3)),
              "poses": poses,
              "K": np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]])}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: _t(v) for k, v in arrays.items()},
            {"brdf_lut": jnp.asarray(j_lut())}, {"brdf_lut": load_brdf_lut(device="cpu")})


def _render_draws(k_render):
    k_strat, _, k_pdf, _ = jax.random.split(k_render, 4)
    return {"strat": _t(jax.random.uniform(k_strat, (B, S))),
            "pdf": _t(jax.random.uniform(k_pdf, (B, SI)))}


def _step_draws(key):
    """JAX's draws of make_train_step's loss_fn for `key`."""
    k_sample, k_render, _, _, _ = jax.random.split(key, 5)
    k_img, k_u, k_v = jax.random.split(k_sample, 3)
    return {"pixels": {"img": _t(jax.random.randint(k_img, (), 0, N_IMAGES)).long(),
                       "u": _t(jax.random.randint(k_u, (B,), 0, W)).long(),
                       "v": _t(jax.random.randint(k_v, (B,), 0, H)).long()},
            "render": _render_draws(k_render)}


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in jax.tree.leaves(tree)])


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# --- detach sites -------------------------------------------------------------

MAPS = ["color_map", "radiance_map", "albedo_map", "irradiance_map", "roughness_map",
        "radiance_map_1", "specular_map", "diffuse_map", "prefiltered_reflected_map",
        "depth_map"]


@pytest.mark.parametrize("name", MAPS)
def test_detach_sites_match_jax(scene, name):
    """The gradient of mean(map^2) into the params, map by map: a missing
    or extra detach changes which params a map reaches, by O(1). The
    shaded maps (color, specular) follow the sgs normal's direction
    through n.v, the LUT and the reflected march; the normal is a
    derivative and moves their gradients by up to 2e-4, hence 1e-3."""
    _, _, jc, tc = scene
    jr, tr = _cfgs(4, approximate_radiance=True, normal_type=SGS)
    jv, tv = _variables(4)
    rng = np.random.default_rng(3)
    ro = (rng.standard_normal((B, 3)) * 0.1).astype(np.float32)
    rd = rng.standard_normal((B, 3)).astype(np.float32)
    key = jax.random.key(1)
    jb = j_batch(jnp.asarray(ro), jnp.asarray(rd), NEAR, FAR)
    ref = jax.grad(lambda v: jnp.mean(j_render_rays(key, v, jc, jb, jr)[name] ** 2))(jv)
    leaves = jax.tree.leaves(tv)
    for p in leaves:
        p.requires_grad_(True)
    out = render_rays(tv, tc, make_ray_batch(_t(ro), _t(rd), NEAR, FAR), tr,
                      draws=_render_draws(key))
    grads = torch.autograd.grad(torch.mean(out[name] ** 2), leaves, allow_unused=True)
    got = np.concatenate([(np.zeros(p.shape, np.float32) if g is None else g.numpy()).reshape(-1)
                          for p, g in zip(leaves, grads)])
    ref = _flat(ref)
    assert (got == 0).sum() == (ref == 0).sum()
    assert _rel(got, ref) < 1e-3


# --- the whole step -----------------------------------------------------------

def _jax_loss_fn(jr, arrays, consts, lcfg, phase):
    """make_train_step's loss_fn, spelled out so that jax.value_and_grad
    can be taken of it."""
    rcfg = jstep.phase_render_config(jr, phase)

    def loss_fn(variables, key):
        k_sample, k_render, k_vol, k_vol_render, _ = jax.random.split(key, 5)
        pixel_info, rays_o, rays_d, *_ = j_sample(k_sample, arrays, B, H, W)
        return jstep.loss_from_batch(variables, (k_render, k_vol, k_vol_render), consts,
                                     pixel_info, rays_o, rays_d, rcfg, lcfg, phase, 0.7,
                                     NEAR, FAR, B)
    return loss_fn


CASES = {
    # (multires, normal, render kw, loss bound, per-group gradient bound)
    "f32-sgs": (4, SGS, dict(compute_dtype="float32"), 1e-5, 2e-4),
    "f32-eps": (4, EPS, dict(compute_dtype="float32"), 1e-5, 2e-4),
    # bf16 gradients on K2/K3 (plain versions against JAX's interpret
    # kernels) and K1 on the reflected march. With ε normals the normals
    # are f32 on both sides and the step agrees to ~1e-5.
    "bf16-kernels-eps": (4, EPS, dict(compute_dtype="bf16_grad", use_pallas_train=True,
                                      use_pallas=True), 1e-4, 1e-4),
    # The sgs normal is the derivative of the bf16 density query: XLA and
    # torch round its bf16 products in another order, the normals move by
    # ~1e-2 and the shading gradients with them (measured 4-5% per group).
    "bf16-kernels-sgs": (4, SGS, dict(compute_dtype="bf16_grad", use_pallas_train=True,
                                      use_pallas=True), 1e-4, 0.15),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_loss_and_grads_match_jax(scene, case):
    jarr, tarr, jc, tc = scene
    multires, normal, kw, loss_tol, grad_tol = CASES[case]
    jr, tr = _cfgs(multires, normal_type=normal, **kw)
    jl, tl = jlosses.LossConfig(**LOSS), tlosses.LossConfig(**LOSS)
    jph, tph = jlosses.resolve_phase(50000, jl), tlosses.resolve_phase(50000, tl)
    jv, tv = _variables(multires)
    key = jax.random.key(5)
    (jloss, jscalars), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jr, jarr, jc, jl, jph), has_aux=True))(jv, key)
    opt = tstep.build_optimizer(tv, lrate=5e-4, lrate_decay=500, lcfg=tl)
    state = tstep.init_train_state(tv, opt)
    step = tstep.make_train_step(tr, tl, tph, opt, tc, H, W, B, 0.7, NEAR, FAR)
    loss, scalars, grads = step.loss_and_grads(state.variables, tarr, _step_draws(key))
    assert abs(float(loss) - float(jloss)) <= loss_tol * abs(float(jloss))
    for k in ("loss_render", "loss_radiance", "loss_prior_albedo", "acc_mean"):
        np.testing.assert_allclose(float(scalars[k]), float(jscalars[k]), rtol=10 * loss_tol,
                                   err_msg=k)
    for group in ("coarse", "fine"):
        got = np.concatenate([g.reshape(-1).numpy() for g in tstep._leaves(grads[group])])
        assert _rel(got, _flat(jgrads[group])) < grad_tol, group


@pytest.mark.parametrize("n_steps", [1, 3])
def test_params_after_steps_match_jax(scene, n_steps):
    """JAX's jitted train step (make_train_step) against the port's over
    1 and 3 steps, fed the same draws, float32 and sgs normals. Adam's
    first update moves a param by ~lr * g / (|g| + 1e-8), so elements
    whose first gradient is near 0 (below 1e-3 of its leaf's largest, or
    below 1e-7) are left out; the rest must agree to 2% of lr per step."""
    jarr, tarr, jc, tc = scene
    jr, tr = _cfgs(4, normal_type=SGS, compute_dtype="float32")
    jl, tl = jlosses.LossConfig(**LOSS), tlosses.LossConfig(**LOSS)
    jph, tph = jlosses.resolve_phase(50000, jl), tlosses.resolve_phase(50000, tl)
    jv, tv = _variables(4)
    lr = 5e-4
    jopt = jstep.build_optimizer(jv, lrate=lr, lrate_decay=500, lcfg=jl)
    jstate = jstep.init_train_state(jv, jopt)
    jfn = jstep.make_train_step(jr, jl, jph, jopt, jc, H, W, B, 0.7, NEAR, FAR, donate=False)
    topt = tstep.build_optimizer(tv, lrate=lr, lrate_decay=500, lcfg=tl)
    tstate = tstep.init_train_state(tv, topt)
    tfn = tstep.make_train_step(tr, tl, tph, topt, tc, H, W, B, 0.7, NEAR, FAR)
    keys = jax.random.split(jax.random.key(9), n_steps)
    g0 = jax.grad(lambda v: _jax_loss_fn(jr, jarr, jc, jl, jph)(v, keys[0])[0])(jv)
    for key in keys:
        jstate, _ = jfn(jstate, key, jarr)
        tstate, _ = tfn(tstate, tarr, draws=_step_draws(key))
    assert tstate.step == n_steps and int(jstate.step) == n_steps
    moved, ref_moved = [], []
    for ref, got, g, start in zip(jax.tree.leaves(jstate.variables),
                                  jax.tree.leaves(tstate.variables),
                                  jax.tree.leaves(g0), jax.tree.leaves(jv)):
        moved.append(got.detach().numpy().reshape(-1) - np.asarray(start).reshape(-1))
        ref_moved.append((np.asarray(ref) - np.asarray(start)).reshape(-1))
        if n_steps == 1:
            g = np.abs(np.asarray(g)).reshape(-1)
            live = g > max(1e-3 * g.max(), 1e-7)
            assert np.abs(moved[-1] - ref_moved[-1])[live].max(initial=0.0) <= 0.02 * lr
    # after 3 steps, small gradients have been through 3 normalisations:
    # hold the whole update to 2e-2 of its norm
    assert _rel(np.concatenate(moved), np.concatenate(ref_moved)) < 2e-2


def test_train_step_draws_from_a_generator(scene):
    """Without draws the step draws from the generator: the same seed
    gives the same step, and the params move."""
    _, tarr, _, tc = scene
    _, tr = _cfgs(4, normal_type=EPS, compute_dtype="bf16_grad", use_pallas_train=True)
    tl = tlosses.LossConfig(**LOSS)
    _, tv = _variables(4)
    losses = []
    for _ in range(2):
        opt = tstep.build_optimizer(tv, lcfg=tl)
        state = tstep.init_train_state(tv, opt)
        fn = tstep.make_train_step(tr, tl, tlosses.resolve_phase(50000, tl), opt, tc,
                                   H, W, B, 0.7, NEAR, FAR)
        gen = torch.Generator().manual_seed(3)
        state, scalars = fn(state, tarr, generator=gen)
        losses.append(float(scalars["loss_total"]))
        assert not torch.equal(state.variables["fine"]["sigma"]["w"], tv["fine"]["sigma"]["w"])
    assert losses[0] == losses[1] and np.isfinite(losses[0])


def test_train_step_uncovered_modes_raise(scene, monkeypatch):
    """Patch sampling and raw_noise_std, refused until they were ported,
    now step (tests/test_torch_patch_noise.py holds them to JAX); so does
    float64 with use_pallas, refused until K1 had its f64 kernel: a finite
    step whose ε-offset sweeps and reflected marches ran K1 at f64 weights
    (tests/test_torch_fused_field_f64.py holds the step to JAX's)."""
    _, tarr, _, tc = scene
    _, tr = _cfgs(4, normal_type=EPS)
    tl = tlosses.LossConfig(**LOSS)
    _, tv = _variables(4)
    opt = tstep.build_optimizer(tv, lcfg=tl)
    phase = tlosses.resolve_phase(50000, tl)
    step = tstep.make_train_step(tr.replace(raw_noise_std=1.0), tl, phase, opt, tc, H, W, B,
                                 0.7, NEAR, FAR, patch=True)
    state, scalars = step(tstep.init_train_state(tv, opt), tarr,
                          generator=torch.Generator().manual_seed(0))
    assert state.step == 1
    assert np.isfinite(float(scalars["loss_total"]))
    assert float(scalars["patch_depth_smoothness"]) > 0
    step = tstep.make_train_step(tr.replace(compute_dtype="float64", use_pallas=True), tl,
                                 phase, opt, tc, H, W, B, 0.7, NEAR, FAR)
    calls, run = [], tff._run
    monkeypatch.setattr(tff, "_run", lambda packed, x, cfg, density_only, *heads: (
        calls.append((packed["w0"].dtype, density_only))
        or run(packed, x, cfg, density_only, *heads)))
    state, scalars = step(tstep.init_train_state(tv, opt), tarr,
                          generator=torch.Generator().manual_seed(0))
    assert state.step == 1
    assert np.isfinite(float(scalars["loss_total"]))
    assert calls == [(torch.float64, True), (torch.float64, False)] * 2  # coarse, fine
