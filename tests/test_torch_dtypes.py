"""The port's compute dtypes against the JAX renderer's: `amp`, `mixed`,
`bfloat16` (eager and with K1 on the no-grad sweeps) and `float64`.

Both sides render the same 8 rays (8+8 samples, ε-normals) through a
depth-8, width-32 field with the same weights (JAX init through
`field_params_from_numpy`). Tolerances, per map:
- `amp` rounds only the matmul operands to bf16 and sums in f32 on both
  sides, and its no-grad sweeps are plain f32: the f32 bounds of
  tests/test_torch_renderer.py, atol 5e-4 / rtol 1e-3 on the basic maps
  and 2e-3 / 5e-3 on the shaded ones (at ε 0.5, below).
- `mixed` keeps the gradient path f32, so the maps of the primary march
  keep those bounds; the maps that read the bf16 no-grad sweeps
  (ε-normals, reflected march, and the shading built on them) are held
  in relative norm.
- `bfloat16` rounds every query: XLA and torch sum the bf16 products in
  another order, so a hidden unit can round to the neighbouring bf16
  value (2^-8 relative), and the importance samples move with the coarse
  weights. Every map is held in relative norm.
- Finite differences of densities with bf16 operands anywhere are
  chaotic at the default ε (tests/test_dtypes.py:77-87), so every mode
  but float64 renders at `epsilon=0.5`, where the normals mean something.
- `float64` runs f64 on both sides (JAX with x64 switched on for the
  test only): 1e-9, far below any f32 rounding.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_load_lut
from ibl_nerf_tpu.models.field import FieldConfig as JFieldConfig
from ibl_nerf_tpu.models.field import init_field_params as j_init
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.render import make_ray_batch as j_batch
from ibl_nerf_tpu.render import render_rays as j_render_rays
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.kernels import fused_field as tff
from ibl_nerf_tpu_torch.models.field import FieldConfig
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.render import renderer
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

torch.set_num_threads(2)

FIELD = dict(depth=8, width=32, coarse_radiance_number=3)
BASE = dict(n_samples=8, n_importance=8, perturb=False,
            approximate_radiance=True,
            normal_type="normal_map_from_depth_gradient_epsilon",
            correct_depth_for_prefiltered_radiance_infer=True)
SHADED = {"color_map", "specular_map", "diffuse_map", "n_dot_v_map",
          "target_normal_map", "normal_map_from_depth_gradient_epsilon",
          "reflected_radiance_map", "prefiltered_reflected_map"}
# maps that read the no-grad sweeps (ε-normals, reflected march)
SWEPT = SHADED | {f"reflected_coarse_radiance_map_{k}" for k in (1, 2, 3)}
BASIC_TOL, SHADED_TOL = (5e-4, 1e-3), (2e-3, 5e-3)
# relative norm per map for bf16 sweeps or queries: the worst map on
# these inputs (bfloat16's weights, 7.2e-4) sits 4x below it; a wrong
# rounding point or head moves a map by 1e-2 or more
BF16_REL = 3e-3


def _cfgs(field=FIELD, base=BASE, **kw):
    jr = JRenderConfig(field=JFieldConfig(**field), **base).replace(**kw)
    fields = {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)}
    for name in ("field", "field_fine"):
        if fields[name] is not None:
            fields[name] = FieldConfig(**dataclasses.asdict(fields[name]))
    return jr, RenderConfig(**fields)


@pytest.fixture(scope="module")
def setup():
    jcfg = JFieldConfig(**FIELD)
    k1, k2 = jax.random.split(jax.random.key(5))
    jvars = {"coarse": j_init(k1, jcfg), "fine": j_init(k2, jcfg)}
    for v in jvars.values():  # visible density, so depth and normals mean something
        v["sigma"]["b"] = v["sigma"]["b"] + 0.5
    rng = np.random.default_rng(4)
    rays_o = (rng.standard_normal((8, 3)) * 0.1).astype(np.float32)
    rays_d = rng.standard_normal((8, 3)).astype(np.float32)
    return dict(jvars=jax.tree.map(np.asarray, jvars), lut=np.asarray(j_load_lut()),
                rays_o=rays_o, rays_d=rays_d)


_TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tmap(fn, v) for v in tree]
    return fn(tree)


def _render_both(s, dtype=np.float32, **kw):
    """JAX and port maps (numpy) of one render_rays call on `s`'s rays."""
    jr, tr = _cfgs(**kw)
    jvars = jax.tree.map(lambda a: jnp.asarray(a.astype(dtype)), s["jvars"])
    tvars = _tmap(lambda t: t.to(_TORCH[dtype]), field_params_from_numpy(s["jvars"], "cpu"))
    ro, rd = s["rays_o"].astype(dtype), s["rays_d"].astype(dtype)
    ref = jax.jit(lambda b: j_render_rays(jax.random.key(0), jvars,
                                          {"brdf_lut": jnp.asarray(s["lut"].astype(dtype))},
                                          b, jr))(
        j_batch(jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0))
    out = render_rays(tvars, {"brdf_lut": load_brdf_lut(device="cpu").to(_TORCH[dtype])},
        make_ray_batch(torch.from_numpy(ro), torch.from_numpy(rd), 2.0, 6.0), tr)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.detach().numpy() for k, v in out.items()})


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-12))


def _check_maps(ref, out, rel_keys=(), rel=BF16_REL):
    """`rel_keys` within `rel` relative norm, the rest within the f32
    bounds; every map finite and of JAX's shape."""
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert out[k].shape == r.shape, k
        assert np.isfinite(out[k]).all(), k
        if k in rel_keys:
            assert _rel(out[k], r) <= rel, (k, _rel(out[k], r))
        else:
            atol, rtol = SHADED_TOL if k.rstrip("0") in SHADED else BASIC_TOL
            np.testing.assert_allclose(out[k], r, atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["eager", "k1"])
def test_amp_matches_jax(setup, use_pallas):
    """amp rounds every matmul operand, activations included, so a hidden
    unit near a bf16 rounding tie flips as in the bf16 modes; at ε 0.5 the
    f32 bounds hold (worst map 6.4e-4 relative)."""
    ref, out = _render_both(setup, compute_dtype="amp", use_pallas=use_pallas,
                            epsilon=0.5)
    assert out["color_map"].dtype == out["depth_map"].dtype == np.float32
    _check_maps(ref, out)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["eager", "k1"])
def test_mixed_matches_jax(setup, use_pallas):
    """The primary march is f32 and held to the f32 bounds; the maps built
    on the bf16 sweeps within BF16_REL (worst on this input 2.3e-4, the
    reflected radiance with K1)."""
    ref, out = _render_both(setup, compute_dtype="mixed", use_pallas=use_pallas,
                            epsilon=0.5)
    _check_maps(ref, out, rel_keys=SWEPT)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["eager", "k1"])
def test_bfloat16_matches_jax(setup, use_pallas):
    """Every query bf16: every map within BF16_REL (worst on this input
    7.2e-4, the weights)."""
    ref, out = _render_both(setup, compute_dtype="bfloat16", use_pallas=use_pallas,
                            epsilon=0.5)
    assert out["color_map"].dtype == np.float32
    _check_maps(ref, out, rel_keys=set(ref))


@contextlib.contextmanager
def _jax_x64():
    """JAX's x64 mode for one test: xdist workers run other files in the
    same process."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("coarse_shading", [True, False], ids=["coarse", "fast"])
def test_float64_matches_jax(setup, coarse_shading):
    """f64 end to end: nothing drops to f32 on the way (every map f64)."""
    with _jax_x64():
        ref, out = _render_both(setup, dtype=np.float64, compute_dtype="float64",
                                coarse_shading=coarse_shading)
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert r.dtype == out[k].dtype == np.float64, k
        np.testing.assert_allclose(out[k], r, atol=1e-9, rtol=1e-9, err_msg=k)


# ---------------------------------------------------------------------------
# Gradients: tests/test_dtypes.py's semantics on the port, on its fixture
# (depth 2, width 32, K=2, 6 rays), where its bounds were set. At depth 8
# the radiance loss's first-layer gradient is chaotic in any sub-f32
# rounding (JAX's own amp sits 14% from f32 there).
# ---------------------------------------------------------------------------

SEM_FIELD = dict(depth=2, width=32, coarse_radiance_number=2)
SEM_BASE = dict(n_samples=8, n_importance=8, perturb=False, approximate_radiance=True,
                normal_type="normal_map_from_depth_gradient_epsilon")


@pytest.fixture(scope="module")
def sem():
    jcfg = JFieldConfig(**SEM_FIELD)
    jvars = {"coarse": j_init(jax.random.key(0), jcfg),
             "fine": j_init(jax.random.key(2), jcfg)}
    for v in jvars.values():
        v["sigma"]["b"] = v["sigma"]["b"] + 0.5
    rng = np.random.default_rng(1)
    return dict(jvars=jax.tree.map(np.asarray, jvars), lut=np.asarray(j_load_lut()),
                rays_o=rng.standard_normal((6, 3)).astype(np.float32),
                rays_d=rng.standard_normal((6, 3)).astype(np.float32))


def _sem_cfgs(dtype):
    return _cfgs(field=SEM_FIELD, base=SEM_BASE, compute_dtype=dtype)


def _grad(s, dtype, loss_keys=("radiance_map",)):
    """d mean(sum of the maps squared) / d fine trunk[0].w, on the port."""
    tvars = _tmap(lambda t: t.requires_grad_(), field_params_from_numpy(s["jvars"], "cpu"))
    out = render_rays(tvars, {"brdf_lut": load_brdf_lut(device="cpu")},
                      make_ray_batch(torch.from_numpy(s["rays_o"]),
                                     torch.from_numpy(s["rays_d"]), 2.0, 6.0),
                      _sem_cfgs(dtype)[1])
    loss = sum(torch.mean(out[k] ** 2) for k in loss_keys)
    (g,) = torch.autograd.grad(loss, [tvars["fine"]["trunk"][0]["w"]])
    return g


def _jax_grad(s, dtype):
    """The same gradient of the radiance loss, on the JAX renderer."""
    jr = _sem_cfgs(dtype)[0]
    batch = j_batch(jnp.asarray(s["rays_o"]), jnp.asarray(s["rays_d"]), 2.0, 6.0)
    consts = {"brdf_lut": jnp.asarray(s["lut"])}

    def loss(v):
        o = j_render_rays(jax.random.key(0), v, consts, batch, jr)
        return jnp.mean(o["radiance_map"] ** 2)

    g = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, s["jvars"]))
    return np.asarray(g["fine"]["trunk"][0]["w"])


def test_mixed_gradient_path_is_float32s(sem):
    """radiance_map reads only the gradient path, which `mixed` keeps f32:
    its gradients equal float32's bit for bit."""
    assert torch.equal(_grad(sem, "mixed"), _grad(sem, "float32"))


def test_amp_gradients_are_f32_and_closer_than_bfloat16s(sem):
    """On this fixture amp sits 0.060 from f32 and bfloat16 0.102 (JAX:
    0.058 and 0.102)."""
    g32, gamp, gbf = (_grad(sem, d) for d in ("float32", "amp", "bfloat16"))
    assert gamp.dtype == gbf.dtype == torch.float32
    err_amp, err_bf = _rel(gamp, g32), _rel(gbf, g32)
    assert err_amp < 0.1, err_amp
    assert err_amp <= 1.5 * err_bf, (err_amp, err_bf)


@pytest.mark.parametrize("dtype", ["bfloat16", "mixed", "amp"])
def test_master_params_and_gradients_stay_f32(sem, dtype):
    """color and radiance: gradients reach the f32 master params, finite
    and nonzero."""
    g = _grad(sem, dtype, loss_keys=("color_map", "radiance_map"))
    assert g.dtype == torch.float32
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("dtype", ["float32", "amp", "bfloat16"])
def test_gradients_match_jax(sem, dtype):
    """The port's gradient against JAX's in each mode. Even in f32 the two
    sit ~1.2e-2 apart: the fine samples differ in the last bits, and the
    first layer's gradient reads them through sin(2^9 x). 3e-2 keeps a
    2x margin over the worst mode and is far below a wrong rounding point
    (amp against f32 is 6e-2)."""
    assert _rel(_grad(sem, dtype).numpy(), _jax_grad(sem, dtype)) <= 3e-2


def test_k1_packs_at_the_no_grad_dtype(setup, monkeypatch):
    """use_pallas: the sweeps of bfloat16 and mixed run K1's bf16 variant,
    those of float32 and amp the f32 one (on the CPU, their plain
    versions: no launch is counted)."""
    s = setup
    tvars = field_params_from_numpy(s["jvars"], "cpu")
    seen = []
    real = tff.pack_field_weights

    def spy(params, cfg, dtype=torch.float32):
        seen.append(dtype)
        return real(params, cfg, dtype=dtype)

    before = dict(tff.LAUNCHES)
    monkeypatch.setattr(renderer, "pack_field_weights", spy)
    for dtype in ("bfloat16", "mixed", "float32", "amp"):
        seen.clear()
        _, tr = _cfgs(compute_dtype=dtype, use_pallas=True)
        render_rays(tvars, {"brdf_lut": load_brdf_lut(device="cpu")},
                    make_ray_batch(torch.from_numpy(s["rays_o"]),
                                   torch.from_numpy(s["rays_d"]), 2.0, 6.0), tr)
        want = torch.bfloat16 if dtype in ("bfloat16", "mixed") else torch.float32
        assert seen and all(d == want for d in seen), (dtype, seen)
    assert tff.LAUNCHES == before
