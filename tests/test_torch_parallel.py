"""Data parallelism over the devices of one process, the port against
JAX and against its own unsharded step.

The mesh step over 4 CPU shards, fed JAX's draws, is held to the port's
unsharded step and to JAX's `make_sharded_train_step` on 4 of the
conftest's 8 virtual devices: the loss of each update within 1e-5
relative and the params after 2 updates within 1e-5. Against JAX the
params are held where the first update's gradient is above 1e-7: Adam
moves an element by lr g / (|g| + 1e-8), so where |g| is ~1e-9 the
last bits of g (XLA's sums against torch's) move it by up to ~3% of lr;
the whole update is also held to 1e-3 of its norm. The step runs the inferred depth with its
depth-volume pass (whose rays sit in the first shards), merged sampling;
one case rounds n_vol (batch 32, N_depth_random_volume 30, 4 shards ->
28); one samples patches, each shard rendering its own neighbours.
The sharded chunk renderer is held to `render_image`.

Depth 8, width 32, 16-32 rays, 8 + 8 samples.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_lut
from ibl_nerf_tpu.models import aux_mlp as j_aux
from ibl_nerf_tpu.models.field import FieldConfig as JFieldConfig
from ibl_nerf_tpu.models.field import init_field_params as j_init
from ibl_nerf_tpu.parallel import mesh as jmesh
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.train import losses as jlosses
from ibl_nerf_tpu.train import step as jstep
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.data.sampler import pixel_bounds
from ibl_nerf_tpu_torch.models.field import FieldConfig
from ibl_nerf_tpu_torch.parallel import make_mesh, replicate, shard_rays
from ibl_nerf_tpu_torch.parallel.mesh import make_sharded_render_fn, make_sharded_train_step
from ibl_nerf_tpu_torch.render import RenderConfig
from ibl_nerf_tpu_torch.render.renderer import render_image
from ibl_nerf_tpu_torch.train import losses as tlosses
from ibl_nerf_tpu_torch.train import step as tstep
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

torch.set_num_threads(2)

H, W, N_IMAGES, S, SI = 12, 16, 3, 8, 8
NEAR, FAR = 2.0, 6.0
N_DEV = 4
LR = 5e-4
LOSS = dict(infer_depth=True, n_iter_ignore_depth=0, n_iter_ignore_approximated_radiance=0,
            beta_inferred_depth=1.0)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


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
    return ({k: jnp.asarray(v) for k, v in arrays.items()}, {k: _t(v) for k, v in arrays.items()},
            {"brdf_lut": jnp.asarray(j_lut())}, {"brdf_lut": load_brdf_lut(device="cpu")})


def _cfgs():
    field = dict(depth=8, width=32, coarse_radiance_number=3, multires=4)
    base = dict(n_samples=S, n_importance=SI, perturb=True, approximate_radiance=True,
                normal_type="ground_truth", correct_depth_for_prefiltered_radiance_infer=True,
                compute_dtype="float32", infer_depth=True)
    jr = JRenderConfig(field=JFieldConfig(**field), **base)
    fields = {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)}
    fields["field"] = FieldConfig(**dataclasses.asdict(fields["field"]))
    return jr, RenderConfig(**fields)


def _variables():
    cfg = JFieldConfig(depth=8, width=32, coarse_radiance_number=3, multires=4)
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    jv = {"coarse": j_init(k1, cfg), "fine": j_init(k2, cfg),
          "depth_mlp": j_aux.init_position_direction_mlp(k3, 8, 32, cfg.input_ch,
                                                         cfg.input_ch_views, 1)}
    for name in ("coarse", "fine"):
        jv[name]["sigma"]["b"] = jv[name]["sigma"]["b"] + 0.5
    jv["depth_mlp"]["out"]["b"] = jv["depth_mlp"]["out"]["b"] + 3.0
    return jv, field_params_from_numpy(jax.tree.map(np.asarray, jv), "cpu")


def _render_draws(key, n, depth_only=False):
    k_strat, _, k_pdf, _ = jax.random.split(key, 4)
    return {"strat": _t(jax.random.uniform(k_strat, (n, S))),
            "pdf": _t(jax.random.uniform(k_pdf, (n, SI)))}


def _step_draws(key, b, n_vol, merged, patch):
    """JAX's draws of make_(sharded_)train_step's loss_fn for `key`."""
    k_sample, k_render, k_vol, k_vol_render, k_patch = jax.random.split(key, 5)
    k_img, k_u, k_v = jax.random.split(k_sample, 3)
    sh, eh, sw, ew = pixel_bounds(H, W, patch=patch)
    draws = {"pixels": {"img": _t(jax.random.randint(k_img, (b,) if merged else (), 0,
                                                     N_IMAGES)).long(),
                        "u": _t(jax.random.randint(k_u, (b,), sw, ew)).long(),
                        "v": _t(jax.random.randint(k_v, (b,), sh, eh)).long()},
             "render": _render_draws(k_render, b),
             "vol": {"dirs": _t(jax.random.uniform(k_vol, (b, 3)))[:n_vol],
                     "render": _render_draws(k_vol_render, n_vol)}}
    if patch:
        draws["patch"] = _render_draws(k_patch, 8 * b)
    return draws


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in leaves])


CASES = {  # batch, N_depth_random_volume, merged, patch
    "merged": (16, 8, True, False),
    "n_vol-rounds": (32, 30, True, False),
    "patch": (16, 8, False, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_unsharded_and_jax(scene, case):
    b, n_depth, merged, patch = CASES[case]
    jarr, tarr, jc, tc = scene
    jr, tr = _cfgs()
    jl, tl = jlosses.LossConfig(**LOSS), tlosses.LossConfig(**LOSS)
    jph, tph = jlosses.resolve_phase(100, jl), tlosses.resolve_phase(100, tl)
    assert tph.depth_loss_on
    jv, tv = _variables()
    start = _flat(jax.tree.leaves(jv))  # JAX's step donates its state
    n_vol = min(n_depth, b) // N_DEV * N_DEV
    keys = [jax.random.fold_in(jax.random.key(9), i) for i in range(2)]

    jopt = jstep.build_optimizer(jv, lrate=LR, lrate_decay=500, lcfg=jl)
    jfn, place_state, place_arrays = jmesh.make_sharded_train_step(
        jr, jl, jph, jopt, jc, H, W, b, 0.7, NEAR, FAR, jmesh.make_mesh(jax.devices()[:N_DEV]),
        merged_sampling=merged, n_depth_random_volume=n_depth, patch=patch)
    jstate, jarrays = place_state(jstep.init_train_state(jv, jopt)), place_arrays(jarr)

    mesh = make_mesh(["cpu"] * N_DEV)
    steps = {}
    for name, sharded in (("mesh", True), ("unsharded", False)):
        opt = tstep.build_optimizer(tv, lrate=LR, lrate_decay=500, lcfg=tl)
        state = tstep.init_train_state(tv, opt)
        if sharded:
            fn, place, place_arr = make_sharded_train_step(
                tr, tl, tph, opt, tc, H, W, b, 0.7, NEAR, FAR, mesh, merged_sampling=merged,
                n_depth_random_volume=n_depth, patch=patch)
            state, arrays = place(state), place_arr(tarr)
            assert fn.n_vol == n_vol
        else:
            fn = tstep.make_train_step(tr, tl, tph, opt, tc, H, W, b, 0.7, NEAR, FAR,
                                       merged_sampling=merged, n_depth_random_volume=n_vol,
                                       patch=patch)
            arrays = tarr
        steps[name] = (fn, state, arrays)

    fn, state, arrays = steps["unsharded"]
    g0 = _flat([g.numpy() for g in tstep._leaves(fn.loss_and_grads(
        state.variables, arrays, _step_draws(keys[0], b, n_vol, merged, patch))[2])])
    losses = {"jax": [], "mesh": [], "unsharded": []}
    smooth = {"jax": [], "mesh": [], "unsharded": []}
    for key in keys:
        jstate, jsc = jfn(jstate, key, jarrays)
        losses["jax"].append(float(jsc["loss_total"]))
        if patch:
            smooth["jax"].append(float(jsc["patch_depth_smoothness"]))
        draws = _step_draws(key, b, n_vol, merged, patch)
        for name, (fn, state, arrays) in steps.items():
            state, sc = fn(state, arrays, draws=draws)
            losses[name].append(float(sc["loss_total"]))
            assert float(sc["loss_depth"]) > 0
            if patch:
                smooth[name].append(float(sc["patch_depth_smoothness"]))
    for name in ("mesh", "unsharded"):
        np.testing.assert_allclose(losses[name], losses["jax"], rtol=TOL, err_msg=name)
        np.testing.assert_allclose(smooth[name], smooth["jax"], rtol=TOL, err_msg=name)
    np.testing.assert_allclose(losses["mesh"], losses["unsharded"], rtol=TOL)

    ref = _flat(jax.tree.leaves(jstate.variables))
    mesh_params = _flat([p.detach().numpy() for p in tstep._leaves(steps["mesh"][1].variables)])
    flat_params = _flat([p.detach().numpy()
                         for p in tstep._leaves(steps["unsharded"][1].variables)])
    assert np.abs(mesh_params - start).max() > LR  # the params moved
    np.testing.assert_allclose(mesh_params, flat_params, atol=TOL, rtol=0)
    live = np.abs(g0) > 1e-7
    assert live.mean() > 0.5
    np.testing.assert_allclose(mesh_params[live], ref[live], atol=TOL, rtol=0)
    moved, ref_moved = mesh_params - start, ref - start
    assert np.linalg.norm(moved - ref_moved) < 1e-3 * np.linalg.norm(ref_moved)


def test_mesh_helpers():
    mesh = make_mesh(["cpu", "cpu"])
    assert mesh == [torch.device("cpu")] * 2
    x = torch.arange(12.0).reshape(6, 2)
    parts = shard_rays(x, mesh)
    assert [p.shape[0] for p in parts] == [3, 3] and torch.equal(torch.cat(parts), x)
    tree = {"a": [x], "b": x}
    copies = replicate(tree, mesh)
    assert len(copies) == 2 and torch.equal(copies[1]["a"][0], x)


def test_sharded_render_matches_render_image(scene):
    _, _, _, tc = scene
    _, tr = _cfgs()
    tr = tr.replace(perturb=False, infer_depth=False)
    _, tv = _variables()
    tv = {k: tv[k] for k in ("coarse", "fine")}
    K = torch.tensor([[20.0, 0, 8.0], [0, 20.0, 6.0], [0, 0, 1]])
    c2w = torch.eye(4)[:3]
    c2w[2, 3] = 3.5
    gt = {"normal": torch.rand(H * W, 3, generator=torch.Generator().manual_seed(1))}
    render_fn = make_sharded_render_fn(make_mesh(["cpu"] * N_DEV), tv, tc, tr)
    sharded = render_image(tv, tc, H, W, K, c2w, NEAR, FAR, tr, gt_values=gt, chunk=64,
                           render_fn=render_fn)
    single = render_image(tv, tc, H, W, K, c2w, NEAR, FAR, tr, gt_values=gt, chunk=64)
    assert set(sharded) == set(single)
    for k in single:
        assert sharded[k].shape == single[k].shape, k
        np.testing.assert_allclose(sharded[k].numpy(), single[k].numpy(), atol=1e-5, err_msg=k)
    assert sharded["color_map"].shape == (H, W, 3)
