"""The port's depth-gradient normals, edit and insert overrides, static
camera and per-chunk render path against the JAX renderer.

- `normal_from_depth_gradient` and `normal_from_depth_gradient_direction`
  (two `torch.func.jvp` of the depth render) against the JAX functions
  (two `jax.jvp`) on one density field, and both normal types through
  `render_rays` (coarse pass shaded and density-only).
- `render_rays` under `RenderConfig.edit`: per-object constants (normal
  from the edit buffer, albedo, roughness), albedo and roughness from
  images, the edit depth moving the surface point, and object insertion
  (normal, depth, albedo, roughness and irradiance per object), with
  gray-level masks that hit object 1, object 2, both gray bounds' near
  sides and no object.
- `render_image(c2w_staticcam=)`, `make_frame_render_fn(staticcam=True)`
  with `render_frame(viewdirs=)`, and `render_path(fast=False)`.

Depth 4, width 32, 8 rays, 8 + 8 samples, weights from JAX's init
through `field_params_from_numpy`. Tolerances of
tests/test_renderer_parity.py: atol 5e-4 / rtol 1e-3 on the basic maps,
2e-3 / 5e-3 on the shaded ones (the normals among them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_load_lut
from ibl_nerf_tpu.eval.render_path import render_path as j_render_path
from ibl_nerf_tpu.models.field import FieldConfig as JFieldConfig
from ibl_nerf_tpu.models.field import apply_field_density as j_density
from ibl_nerf_tpu.models.field import init_field_params as j_init
from ibl_nerf_tpu.ops.embedding import positional_encoding as j_pe
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.render import make_frame_render_fn as j_frame_fn
from ibl_nerf_tpu.render import make_ray_batch as j_batch
from ibl_nerf_tpu.render import render_frame as j_render_frame
from ibl_nerf_tpu.render import render_image as j_render_image
from ibl_nerf_tpu.render import render_rays as j_render_rays
from ibl_nerf_tpu.render import normals as j_normals
from ibl_nerf_tpu.render.config import EditConfig as JEditConfig
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.eval.render_path import render_path
from ibl_nerf_tpu_torch.models.field import FieldConfig, apply_field_density
from ibl_nerf_tpu_torch.ops.embedding import positional_encoding
from ibl_nerf_tpu_torch.render import (RenderConfig, make_frame_render_fn, make_ray_batch,
                                       render_frame, render_image, render_rays)
from ibl_nerf_tpu_torch.render import normals
from ibl_nerf_tpu_torch.render.config import EditConfig
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

torch.set_num_threads(2)

FIELD = dict(depth=4, width=32, coarse_radiance_number=3)
BASE = dict(n_samples=8, n_importance=8, perturb=False, approximate_radiance=True,
            normal_type="normal_map_from_depth_gradient_epsilon",
            correct_depth_for_prefiltered_radiance_infer=True)
SHADED = {"color_map", "specular_map", "diffuse_map", "n_dot_v_map", "target_normal_map",
          "reflected_radiance_map", "prefiltered_reflected_map",
          "normal_map_from_depth_gradient", "normal_map_from_depth_gradient_direction",
          "normal_map_from_depth_gradient_epsilon"}
BASIC_TOL, SHADED_TOL = (5e-4, 1e-3), (2e-3, 5e-3)
B = 8
AUTOGRAD_TYPES = ("normal_map_from_depth_gradient", "normal_map_from_depth_gradient_direction")


def _cfgs(**kw):
    jr = JRenderConfig(field=JFieldConfig(**FIELD), **BASE).replace(**kw)
    fields = {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)}
    fields["field"] = FieldConfig(**dataclasses.asdict(fields["field"]))
    if fields["edit"] is not None:
        fields["edit"] = EditConfig(**dataclasses.asdict(fields["edit"]))
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
    # gray levels: object 1 (10/255, 9.5/255), object 2 (20/255, 21.5/255),
    # outside every object's band but > 0 (15/255), none (0), the bands'
    # open edges (9/255 and 11/255 belong to no object)
    levels = np.array([10, 9.5, 20, 21.5, 15, 0, 9, 11], np.float32) / 255.0
    mask = np.repeat(levels[:, None], 3, 1)
    gt = {"edit_intrinsic_mask": mask, "object_insert_mask": mask,
          "edit_albedo": rng.uniform(0, 1, (B, 3)), "edit_roughness": rng.uniform(0, 1, (B, 1)),
          "edit_normal": rng.uniform(0, 1, (B, 3)), "edit_depth": rng.uniform(2.5, 5.0, (B, 1)),
          "object_insert_normal": rng.uniform(0, 1, (B, 3)),
          "object_insert_depth": rng.uniform(2.5, 5.0, (B, 1))}
    gt = {k: np.asarray(v, np.float32) for k, v in gt.items()}
    return dict(jvars=jvars, tvars=tvars, jconsts={"brdf_lut": jnp.asarray(j_load_lut())},
                tconsts={"brdf_lut": load_brdf_lut(device="cpu")}, rays_o=rays_o,
                rays_d=rays_d, gt=gt)


def _render_both(s, gt=None, **kw):
    jr, tr = _cfgs(**kw)
    jgt = {k: jnp.asarray(v) for k, v in gt.items()} if gt else None
    ref = jax.jit(lambda b: j_render_rays(jax.random.key(0), s["jvars"], s["jconsts"], b, jr,
                                          gt_values=jgt))(
        j_batch(jnp.asarray(s["rays_o"]), jnp.asarray(s["rays_d"]), 2.0, 6.0))
    out = render_rays(s["tvars"], s["tconsts"], make_ray_batch(
        torch.from_numpy(s["rays_o"]), torch.from_numpy(s["rays_d"]), 2.0, 6.0), tr,
        gt_values={k: torch.from_numpy(v) for k, v in gt.items()} if gt else None)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in out.items()}


def _assert_maps(ref, out):
    assert set(out) == set(ref)
    for k, r in ref.items():
        atol, rtol = SHADED_TOL if k.rstrip("0") in SHADED else BASIC_TOL
        assert out[k].shape == r.shape, k
        np.testing.assert_allclose(out[k], r, atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("name", ["normal_from_depth_gradient",
                                  "normal_from_depth_gradient_direction"])
def test_depth_gradient_normals_match_jax_jvp(setup, name):
    """The estimator alone on the fine field's density: unit normals
    within the shaded tolerance of JAX's two jax.jvp."""
    jcfg, tcfg = JFieldConfig(**FIELD), FieldConfig(**FIELD)
    jp, tp = setup["jvars"]["fine"], setup["tvars"]["fine"]
    z = np.sort(np.random.default_rng(5).uniform(2.0, 6.0, (B, 16)), -1).astype(np.float32)
    ref = getattr(j_normals, name)(lambda p: j_density(jp, j_pe(p, jcfg.multires), jcfg),
                                   jnp.asarray(setup["rays_o"]), jnp.asarray(setup["rays_d"]),
                                   jnp.asarray(z))
    with torch.no_grad():
        out = getattr(normals, name)(
            lambda p: apply_field_density(tp, positional_encoding(p, tcfg.multires), tcfg),
            torch.from_numpy(setup["rays_o"]), torch.from_numpy(setup["rays_d"]),
            torch.from_numpy(z))
    assert not out.requires_grad
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=SHADED_TOL[0],
                               rtol=SHADED_TOL[1])


@pytest.mark.parametrize("normal_type", AUTOGRAD_TYPES)
@pytest.mark.parametrize("coarse_shading", [True, False], ids=["coarse", "fast"])
def test_render_rays_depth_gradient_normals(setup, normal_type, coarse_shading):
    ref, out = _render_both(setup, normal_type=normal_type, coarse_shading=coarse_shading)
    assert normal_type in out
    _assert_maps(ref, out)


def test_depth_gradient_normals_carry_no_gradient(setup):
    """With grad on, the normal (and n·v) is detached while the radiance
    keeps its graph, as JAX's stop_gradient leaves them."""
    _, tr = _cfgs(normal_type="normal_map_from_depth_gradient")
    tvars = {k: {n: v for n, v in p.items()} for k, p in setup["tvars"].items()}
    leaf = tvars["fine"]["sigma"]["w"].clone().requires_grad_(True)
    tvars["fine"]["sigma"] = {"w": leaf, "b": tvars["fine"]["sigma"]["b"]}
    out = render_rays(tvars, setup["tconsts"], make_ray_batch(
        torch.from_numpy(setup["rays_o"]), torch.from_numpy(setup["rays_d"]), 2.0, 6.0), tr)
    assert not out["target_normal_map"].requires_grad
    assert out["radiance_map"].requires_grad


EDITS = {
    "constants": JEditConfig(mode="edit", num_objects=2, edit_normal=True, edit_albedo=True,
                             edit_roughness=True, target_albedo=(0.9, 0.1, 0.1, 0.1, 0.8, 0.2),
                             target_roughness=(0.3, 0.7)),
    "by_image": JEditConfig(mode="edit", num_objects=1, edit_albedo=True,
                            edit_albedo_by_img=True, edit_roughness=True,
                            edit_roughness_by_img=True),
    "edit_depth": JEditConfig(mode="edit", num_objects=2, edit_albedo=True, edit_depth=True,
                              target_albedo=(0.2, 0.4, 0.6, 0.8, 0.6, 0.4)),
    "insert": JEditConfig(mode="insert", num_objects=2,
                          target_albedo=(0.7, 0.7, 0.7, 0.2, 0.3, 0.9),
                          target_roughness=(0.2, 0.9), target_irradiance=(0.5, 0.0)),
}


@pytest.mark.parametrize("coarse_shading", [True, False], ids=["coarse", "fast"])
@pytest.mark.parametrize("edit", list(EDITS))
def test_render_rays_edit_and_insert_match_jax(setup, edit, coarse_shading):
    ref, out = _render_both(setup, gt=setup["gt"], edit=EDITS[edit],
                            coarse_shading=coarse_shading)
    _assert_maps(ref, out)
    _, plain = _render_both(setup, coarse_shading=coarse_shading)
    # the overrides act on the masked rays only: rays 4 and 6-7 (no
    # object) and 5 (mask 0) keep the unedited intrinsics
    inside = np.array([1, 1, 1, 1, 0, 0, 0, 0], bool)
    if EDITS[edit].num_objects == 1:
        inside = np.array([1, 1, 0, 0, 0, 0, 0, 0], bool)
    if edit != "by_image":
        np.testing.assert_array_equal(out["albedo_map"][~inside], plain["albedo_map"][~inside])
    if edit == "constants":
        np.testing.assert_allclose(out["albedo_map"][:2], [[0.9, 0.1, 0.1]] * 2, atol=1e-7)
        np.testing.assert_allclose(out["roughness_map"][2:4], 0.7, atol=1e-7)
    if edit == "insert":
        any_object = setup["gt"]["object_insert_mask"][:, 0] > 0  # all but ray 5
        np.testing.assert_allclose(out["target_depth_map"][any_object],
                                   setup["gt"]["object_insert_depth"][any_object, 0], atol=1e-7)
        np.testing.assert_allclose(out["irradiance_map"][:2], 0.5, atol=1e-7)


def test_staticcam_render_image_matches_jax(setup):
    """Rays from c2w_staticcam, viewdirs from c2w."""
    jr, tr = _cfgs(coarse_shading=False)
    c2w, static = _Scene().poses
    K = np.array([[7.0, 0, 4.0], [0, 7.0, 3.0], [0, 0, 1]], np.float32)
    fn = jax.jit(lambda k, b, g: j_render_rays(k, setup["jvars"], setup["jconsts"], b, jr, g))
    ref = j_render_image(jax.random.key(0), setup["jvars"], setup["jconsts"], 6, 8,
                         jnp.asarray(K), jnp.asarray(c2w), 2.0, 6.0, jr, chunk=16,
                         render_fn=fn, c2w_staticcam=jnp.asarray(static))
    out = render_image(setup["tvars"], setup["tconsts"], 6, 8, torch.from_numpy(K),
                       torch.from_numpy(c2w), 2.0, 6.0, tr, chunk=16,
                       c2w_staticcam=torch.from_numpy(static))
    assert out["color_map"].shape == (6, 8, 3)
    _assert_maps({k: np.asarray(v) for k, v in ref.items()},
                 {k: v.numpy() for k, v in out.items()})
    plain = render_image(setup["tvars"], setup["tconsts"], 6, 8, torch.from_numpy(K),
                         torch.from_numpy(static), 2.0, 6.0, tr, chunk=16)
    np.testing.assert_array_equal(out["depth_map"].numpy(), plain["depth_map"].numpy())


def test_staticcam_frame_fn_matches_jax(setup):
    jr, tr = _cfgs(coarse_shading=False)
    keys = ("color_map", "depth_map", "target_normal_map")
    rng = np.random.default_rng(8)
    vd = rng.standard_normal((B, 3)).astype(np.float32)
    jfn = j_frame_fn(setup["jvars"], setup["jconsts"], jr, output_keys=keys, staticcam=True)
    ref = j_render_frame(jfn, jax.random.key(0), jnp.asarray(setup["rays_o"]),
                         jnp.asarray(setup["rays_d"]), 2.0, 6.0, chunk=3,
                         viewdirs=jnp.asarray(vd))
    fn = make_frame_render_fn(setup["tvars"], setup["tconsts"], tr, output_keys=keys,
                              staticcam=True)
    out = render_frame(fn, torch.from_numpy(setup["rays_o"]), torch.from_numpy(setup["rays_d"]),
                       2.0, 6.0, chunk=3, viewdirs=torch.from_numpy(vd))
    assert set(out) == set(keys)
    _assert_maps({k: np.asarray(v) for k, v in ref.items()},
                 {k: v.numpy() for k, v in out.items()})


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


@pytest.mark.parametrize("kw", [{}, dict(use_radiance_linear=True, gamma_correct=True)],
                         ids=["ldr", "hdr_gamma"])
def test_render_path_per_chunk_matches_jax(setup, kw):
    """fast=False: the coarse pass shaded, chunk by chunk through
    render_image; its buffers equal the fast path's within the same
    tolerances (the coarse query runs at another batch shape).

    The autograd depth-gradient normals are held on equal batches
    (test_render_rays_depth_gradient_normals): their derivative is a
    difference of large sums, so f32 summation order moves it. One ray
    of this scene alone gives n.v 0.42619 in JAX and in the port, inside
    a 16-ray chunk 0.43541 in JAX, and 0.43542 in float64."""
    jr, tr = _cfgs(**kw)
    scene = _Scene()
    ref = j_render_path(setup["jvars"], setup["jconsts"], scene, jr, chunk=16, fast=False)
    out = render_path(setup["tvars"], setup["tconsts"], scene, tr, chunk=16, fast=False)
    fast = render_path(setup["tvars"], setup["tconsts"], scene, tr, chunk=16)
    assert set(out) == set(ref) == set(fast)
    for k, r in ref.items():
        assert out[k].shape == r.shape and out[k].shape[:3] == (2, 6, 8), k
        shaded = k in ("rgb", "specular", "diffuse", "n_dot_v", "target_normal_map",
                       "reflected_radiance", "prefiltered_reflected",
                       "normal_from_depth") or k.startswith("reflected_coarse")
        atol, rtol = SHADED_TOL if shaded else BASIC_TOL
        np.testing.assert_allclose(out[k], r, atol=atol, rtol=rtol, err_msg=k)
        np.testing.assert_allclose(out[k], fast[k], atol=atol, rtol=rtol, err_msg=k)
