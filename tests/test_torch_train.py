"""The train step's parts against the JAX package: phases, losses, the
optimizer, pixel sampling, sgs normals and the field's freeze gradients.

Inputs are made from numpy seeds and handed to both sides; where the JAX
side draws from a PRNG key, the test reproduces the key tree and passes
the draws to the port. Small fields (depth 8, width 32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ibl_nerf_tpu.data.sampler import sample_pixel_batch as j_sample
from ibl_nerf_tpu.models import field as jfield
from ibl_nerf_tpu.ops.embedding import positional_encoding as jpe
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.render import normals as jnormals
from ibl_nerf_tpu.render.renderer import _make_queries as j_make_queries
from ibl_nerf_tpu.train import losses as jlosses
from ibl_nerf_tpu.train.step import build_optimizer as j_build_optimizer
from ibl_nerf_tpu_torch.data.sampler import draw_pixels, pixel_bounds, sample_pixel_batch
from ibl_nerf_tpu_torch.models import field as tfield
from ibl_nerf_tpu_torch.ops.embedding import positional_encoding
from ibl_nerf_tpu_torch.render import RenderConfig
from ibl_nerf_tpu_torch.render import normals as tnormals
from ibl_nerf_tpu_torch.render.renderer import FieldQueries
from ibl_nerf_tpu_torch.train import losses as tlosses
from ibl_nerf_tpu_torch.train.step import (
    _group_schedule,
    _leaves,
    build_optimizer,
    init_train_state,
)
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _field(multires=10, seed=0):
    kw = dict(depth=8, width=32, coarse_radiance_number=3, multires=multires)
    jcfg, tcfg = jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)
    jp = jax.jit(jfield.init_field_params, static_argnums=1)(jax.random.key(seed), jcfg)
    jp["sigma"]["b"] = jp["sigma"]["b"] + 0.5
    return jcfg, tcfg, jp, field_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# --- phases and losses --------------------------------------------------------

LOSS_CONFIGS = {
    "bench": dict(load_priors=True, freeze_roughness=True,
                  n_iter_ignore_approximated_radiance=10000, n_iter_ignore_prior=100000,
                  beta_prior_albedo=1.0, beta_irradiance_reg=0.1),
    "default": {},
    "freeze_radiance": dict(freeze_radiance=True),
    "aux": dict(initialize_roughness=True, infer_normal=True, infer_depth=True,
                load_priors=True, freeze_roughness=True),
}


@pytest.mark.parametrize("name", sorted(LOSS_CONFIGS))
def test_resolve_phase_matches_jax(name):
    kw = LOSS_CONFIGS[name]
    jl, tl = jlosses.LossConfig(**kw), tlosses.LossConfig(**kw)
    for step in (0, 4999, 5000, 9999, 10000, 14999, 15000, 50000, 99999, 100000, 120000):
        assert (dataclasses.asdict(tlosses.resolve_phase(step, tl))
                == dataclasses.asdict(jlosses.resolve_phase(step, jl))), step


def _loss_inputs(seed=0, b=16):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(0.05, 0.95, s).astype(np.float32)  # noqa: E731
    result = {}
    for suffix in ("", "0"):
        result.update({f"color_map{suffix}": u(b, 3), f"radiance_map{suffix}": u(b, 3),
                       f"albedo_map{suffix}": u(b, 3), f"irradiance_map{suffix}": u(b, 1),
                       f"roughness_map{suffix}": u(b), f"depth_map{suffix}": u(b) * 6,
                       f"target_normal_map{suffix}": u(b, 3) * 2 - 1})
        result.update({f"radiance_map_{k}{suffix}": u(b, 3) for k in (1, 2, 3)})
    result.update(acc_map=u(b), inferred_normal_map=u(b, 3) * 2 - 1,
                  inferred_depth_map=u(b) * 6)
    pixel = {"rgb": u(b, 3), "albedo": u(b, 3), "prior_albedo": u(b, 3),
             "prior_irradiance": u(b), "normal": u(b, 3), "depth": u(b, 1) * 6}
    pixel.update({f"rgb_{k}": u(b, 3) for k in (1, 2, 3)})
    return result, pixel


PHASES = {
    # A: warm-up, roughness initialisation on, no shading
    "A": (dict(initialize_roughness=True, learn_albedo_from_oracle=True), 0),
    # B: the bench's phase, approximate radiance on
    "B": (LOSS_CONFIGS["bench"], 50000),
    # C: priors (rgb), the inferred-normal and depth losses, gt depth
    "C": (dict(load_priors=True, n_iter_ignore_prior=0, beta_prior_irradiance=0.5,
               beta_irradiance_reg=0.1, infer_normal=True, n_iter_ignore_normal=0,
               infer_depth=True, n_iter_ignore_depth=0, depth_map_from_ground_truth=True,
               train_depth_from_ground_truth=True), 20000),
    # C with the chromaticity prior and the gt-normal target
    "C-chrom": (dict(load_priors=True, n_iter_ignore_prior=0, albedo_prior_type="chrom",
                     infer_normal=True, n_iter_ignore_normal=0,
                     infer_normal_target="ground_truth"), 20000),
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_compute_losses_matches_jax(name):
    kw, step = PHASES[name]
    jl, tl = jlosses.LossConfig(**kw), tlosses.LossConfig(**kw)
    result, pixel = _loss_inputs()
    jt, js = jlosses.compute_losses({k: jnp.asarray(v) for k, v in result.items()},
                                    {k: jnp.asarray(v) for k, v in pixel.items()},
                                    jl, jlosses.resolve_phase(step, jl), 0.7, 6.0)
    tt, ts = tlosses.compute_losses({k: _t(v) for k, v in result.items()},
                                    {k: _t(v) for k, v in pixel.items()},
                                    tl, tlosses.resolve_phase(step, tl), 0.7, 6.0)
    assert set(ts) == set(js)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-6, atol=1e-8,
                                   err_msg=k)


# --- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("options", [{}, dict(group_lr_overrides={"coarse": 1e-3},
                                               normal_feeds_shading=True)],
                         ids=["groups", "overrides"])
def test_adam_schedule_and_delayed_start_match_optax(options):
    """Three updates fed the same gradients: a plain group, a group
    delayed until its loss starts (normal_mlp, 2 updates; with
    normal_feeds_shading it keeps only the schedule offset), and a group
    with a schedule offset but no delay (roughness_mlp under
    initialize_roughness). decay_steps = 2 so the schedule moves."""
    rng = np.random.default_rng(0)
    shapes = {"coarse": {"w": (5, 4), "b": (4,)}, "normal_mlp": [{"w": (3, 2)}],
              "roughness_mlp": {"w": (2, 2)}}
    jvars = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32),
                         shapes, is_leaf=lambda s: isinstance(s, tuple))
    kw = dict(n_iter_ignore_normal=2, initialize_roughness=True,
              n_iter_ignore_approximated_radiance=1)
    jopt = j_build_optimizer(jvars, lrate=5e-4, lrate_decay=0.002,
                             lcfg=jlosses.LossConfig(**kw), **options)
    jstate = jopt.init(jvars)
    tvars = field_params_from_numpy(jax.tree.map(np.asarray, jvars), "cpu")
    topt = build_optimizer(tvars, lrate=5e-4, lrate_decay=0.002,
                           lcfg=tlosses.LossConfig(**kw), **options)
    state = init_train_state(tvars, topt)
    start = jax.tree.map(np.asarray, jvars)
    for i in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                             jvars)
        updates, jstate = jopt.update(grads, jstate, jvars)
        jvars = optax.apply_updates(jvars, updates)
        topt.update_(state.variables, field_params_from_numpy(
            jax.tree.map(np.asarray, grads), "cpu"), state.opt_state)
        for name in shapes:
            ref = [np.asarray(x) for x in jax.tree.leaves(jvars[name])]
            out = [x.detach().numpy() for x in _leaves(state.variables[name])]
            for r, o in zip(ref, out):
                np.testing.assert_allclose(o, r, rtol=1e-6, atol=2e-7, err_msg=(i, name))
    # the delayed group moved only in its third update
    moved = np.asarray(jvars["normal_mlp"][0]["w"]) - start["normal_mlp"][0]["w"]
    assert np.abs(moved).max() > 0
    assert state.opt_state["normal_mlp"].count == (3 if options else 1)


def test_group_schedule_offset():
    """Update #c runs at lrate*0.1^(max(c-1-start, 0)/decay_steps)."""
    sched = _group_schedule(1.0, 10.0, start=2)
    assert [float(sched(c)) for c in (0, 1, 2, 3)] == [1.0, 1.0, 1.0, 1.0]
    np.testing.assert_allclose(float(sched(13)), 0.1, rtol=1e-6)


# --- pixel sampling -----------------------------------------------------------

@pytest.mark.parametrize("precrop", [False, True], ids=["full", "precrop"])
def test_sample_pixel_batch_matches_jax(precrop):
    rng = np.random.default_rng(1)
    n, h, w, b = 3, 10, 14, 32
    poses = np.stack([np.eye(4, dtype=np.float32)] * n)
    poses[:, :3, 3] = rng.standard_normal((n, 3))
    arrays = {"images": rng.uniform(0, 1, (n, h, w, 3)), "poses": poses,
              "prefiltered_images": rng.uniform(0, 1, (3, n, h, w, 3)),
              "K": np.array([[9.0, 0, w / 2], [0, 9.0, h / 2], [0, 0, 1]]),
              "normal": rng.uniform(0, 1, (n, h, w, 3)),
              "prior_irradiance": rng.uniform(0, 1, (n, h, w, 3))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    key = jax.random.key(4)
    ref = j_sample(key, {k: jnp.asarray(v) for k, v in arrays.items()}, b, h, w,
                   precrop=precrop, precrop_frac=0.5)
    k_img, k_u, k_v = jax.random.split(key, 3)
    sh, eh, sw, ew = pixel_bounds(h, w, precrop, 0.5)
    draws = {"img": _t(jax.random.randint(k_img, (), 0, n)).long(),
             "u": _t(jax.random.randint(k_u, (b,), sw, ew)).long(),
             "v": _t(jax.random.randint(k_v, (b,), sh, eh)).long()}
    pixel, rays_o, rays_d = sample_pixel_batch({k: _t(v) for k, v in arrays.items()},
                                               b, h, w, precrop, 0.5, draws=draws)
    assert set(pixel) == set(ref[0])
    for k in pixel:
        np.testing.assert_array_equal(pixel[k].numpy(), np.asarray(ref[0][k]), err_msg=k)
    np.testing.assert_allclose(rays_o.numpy(), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_allclose(rays_d.numpy(), np.asarray(ref[2]), atol=1e-6)

    gen = torch.Generator().manual_seed(0)
    d = draw_pixels(n, 4096, h, w, "cpu", gen, precrop, 0.5)
    assert d["img"].shape == () and 0 <= int(d["img"]) < n
    assert int(d["u"].min()) == sw and int(d["u"].max()) == ew - 1
    assert int(d["v"].min()) == sh and int(d["v"].max()) == eh - 1


class _Scene:
    """The SceneData surface the sampler reads."""

    def __init__(self, rng):
        self.images = rng.uniform(0, 1, (2, 4, 5, 3)).astype(np.float32)
        self.prefiltered_images = rng.uniform(0, 1, (3, 2, 4, 5, 3)).astype(np.float32)
        self.poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
        self.normal = rng.uniform(0, 1, (2, 4, 5, 3)).astype(np.float32)

    def focal_matrix(self):
        return np.array([[3.0, 0, 2.5], [0, 3.0, 2.0], [0, 0, 1]], np.float32)

    def gt_buffers(self):
        return {"normal": self.normal}


def test_device_arrays_from_scene_matches_jax():
    from ibl_nerf_tpu.data.sampler import device_arrays_from_scene as j_arrays
    from ibl_nerf_tpu_torch.data.sampler import device_arrays_from_scene

    scene = _Scene(np.random.default_rng(6))
    ref = j_arrays(scene, include=("normal", "depth"))
    out = device_arrays_from_scene(scene, include=("normal", "depth"), device="cpu")
    assert set(out) == set(ref) == {"images", "poses", "K", "prefiltered_images", "normal"}
    for k in ref:
        assert out[k].dtype == torch.float32
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_uncovered_sampling_modes_raise():
    """Patch sampling, refused until it was ported, now draws a batch
    with its neighbours (tests/test_torch_patch_noise.py holds it to
    JAX's); only patch with merged sampling raises, since the neighbour
    rays take the batch's one pose (JAX's fails on the shapes)."""
    arrays = {"images": torch.rand(2, 4, 5, 3), "poses": torch.eye(4).expand(2, 4, 4),
              "K": torch.tensor([[3.0, 0, 2.5], [0, 3.0, 2.0], [0, 0, 1]])}
    pixel, rays_o, rays_d, neigh, rays_o_n, rays_d_n = sample_pixel_batch(
        arrays, 6, 4, 5, patch=True, generator=torch.Generator().manual_seed(0))
    assert neigh["rgb"].shape == (6, 8, 3) and rays_o_n.shape == rays_d_n.shape == (6, 8, 3)
    with pytest.raises(ValueError, match="merged"):
        sample_pixel_batch(arrays, 2, 4, 5, patch=True, merged=True)


# --- sgs normals and the freeze gradients -------------------------------------

def _queries(jp, tp, jcfg, tcfg, **kw):
    jr = JRenderConfig(field=jcfg, **kw)
    tr = RenderConfig(field=tcfg, **kw)
    return j_make_queries(jp, jr)[1], FieldQueries(tp, tr).sigma


@pytest.mark.parametrize("multires,atol", [(4, 1e-5), (10, 2e-3)], ids=["mr4", "mr10"])
def test_sgs_normals_float32(multires, atol):
    """The density-gradient normals at the surface and composited along
    the ray. At multires 10 the normal is a derivative of sin(2^9 x):
    1-ulp differences of sin/cos between XLA and torch move it by up to
    ~1e-3, hence the looser bound there."""
    jcfg, tcfg, jp, tp = _field(multires)
    jq, tq = _queries(jp, tp, jcfg, tcfg)
    rng = np.random.default_rng(2)
    xs = rng.uniform(-0.5, 0.5, (16, 3)).astype(np.float32)
    ref = jnormals.normal_from_sigma_gradient_surface(lambda p: jq(p)[..., 0], jnp.asarray(xs))
    out = tnormals.normal_from_sigma_gradient_surface(tq, _t(xs))
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1), 1.0, atol=1e-5)

    pts = rng.uniform(-0.5, 0.5, (6, 5, 3)).astype(np.float32)
    wts = rng.uniform(0, 1, (6, 5)).astype(np.float32)
    ref = jnormals.normal_from_sigma_gradient(lambda p: jq(p)[..., 0], jnp.asarray(pts),
                                              jnp.asarray(wts))
    out = tnormals.normal_from_sigma_gradient(tq, _t(pts), _t(wts))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


def test_freeze_phase_sgs_normals_are_zero_as_in_the_reference():
    """A defect of the JAX reference, reproduced on purpose: under a
    freeze phase the density query stop_gradients sigma, jax.grad of it
    is 0 and the sgs normal is the zero vector. The port gives the same
    zeros (ROADMAP §3 records the defect for a later decision)."""
    jcfg, tcfg, jp, tp = _field()
    xs = np.random.default_rng(3).uniform(-0.5, 0.5, (8, 3)).astype(np.float32)
    for freeze in (False, True):
        jq, tq = _queries(jp, tp, jcfg, tcfg, freeze_radiance=freeze)
        ref = np.asarray(jnormals.normal_from_sigma_gradient_surface(
            lambda p: jq(p)[..., 0], jnp.asarray(xs)))
        out = tnormals.normal_from_sigma_gradient_surface(tq, _t(xs)).numpy()
        if freeze:
            assert not ref.any() and not out.any()
        else:
            np.testing.assert_allclose(np.linalg.norm(ref, axis=-1), 1.0, atol=1e-5)
            np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("freeze_radiance,freeze_roughness",
                         [(False, False), (True, False), (False, True), (True, True)])
def test_field_grads_under_freeze(freeze_radiance, freeze_roughness):
    """Gradients of the full and the density query into every param: the
    same values, and zero for exactly the params JAX stops."""
    jcfg, tcfg, jp, tp = _field(multires=4)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    dirs = rng.standard_normal((12, 3)).astype(np.float32)
    wts = rng.standard_normal((12, 18)).astype(np.float32)
    fr = dict(freeze_radiance=freeze_radiance, freeze_roughness=freeze_roughness)

    def jloss(p):
        pe, de = jpe(jnp.asarray(pts), 4), jpe(jnp.asarray(dirs), 4)
        raw = jfield.apply_field(p, pe, de, jcfg, **fr)
        sig = jfield.apply_field_density(p, pe, jcfg, freeze_radiance=freeze_radiance)
        return jnp.sum(raw * wts) + jnp.sum(sig ** 2)

    def tloss(p):
        pe, de = positional_encoding(_t(pts), 4), positional_encoding(_t(dirs), 4)
        raw = tfield.apply_field(p, pe, de, tcfg, **fr)
        sig = tfield.apply_field_density(p, pe, tcfg, freeze_radiance=freeze_radiance)
        return torch.sum(raw * _t(wts)) + torch.sum(sig ** 2)

    ref = jax.tree.leaves(jax.grad(jloss)(jp))
    leaves = jax.tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    out = torch.autograd.grad(tloss(tp), leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    for r, o in zip(ref, out):
        r = np.asarray(r)
        o = np.zeros_like(r) if o is None else o.numpy()
        assert (r == 0).all() == (o == 0).all()
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-6 * np.abs(r).max())
    # of the 46 leaves, freezing keeps albedo(_feat), irradiance(_feat) and
    # roughness (unless it is frozen too) trainable
    frozen = sum(not np.asarray(r).any() for r in ref)
    assert frozen == (0 if not freeze_radiance else (38 if freeze_roughness else 36))
