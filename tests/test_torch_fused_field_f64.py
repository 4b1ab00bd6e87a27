"""K1 at f64 weights (compute_dtype "float64" with use_pallas) against the
JAX package, which runs its Pallas kernel at f64 weights in interpret mode
off the TPU.

- The f64 pack equals JAX's `pack_field_weights(..., dtype=float64)` bit
  for bit (minus its TPU-only padding).
- `_field_plain_f64` rounds where the JAX kernel rounds: given JAX's own
  sines for the embedding, it equals the interpret-mode kernel bit for
  bit at widths 32 and 256. With torch's sines, which differ from XLA's
  by an ulp on ~5% of f32 inputs, it stays within REL_FULL (1e-7) and
  REL_DENSITY (2e-7) relative norm: measured 3e-8 and 7e-8 (the density,
  a small sum with cancellation, moves more). The same math on f32
  operands (K1-f32's plain version on an f32 pack) sits at 1.6e-7 and
  3.2e-7 at width 256 and fails both: the negative control.
- render_rays, a train step and the CLIs run the mode on the CPU; the
  render and the step are held to JAX's with JAX's x64 switched on for
  the test only (xdist runs other files in the same process).

The CUDA kernel runs only on the card, where chip_smoke.py holds it
against this plain version.
"""

import contextlib
import dataclasses
import functools
import json
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_lut
from ibl_nerf_tpu.kernels import fused_field as jff
from ibl_nerf_tpu.models import field as jfield
from ibl_nerf_tpu.render import RenderConfig as JRenderConfig
from ibl_nerf_tpu.render import make_ray_batch as j_batch
from ibl_nerf_tpu.render import render_rays as j_render_rays
from ibl_nerf_tpu.train import losses as jlosses
from ibl_nerf_tpu_torch.cli import test as cli_test
from ibl_nerf_tpu_torch.cli.config import parse_with_includes
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.kernels import fused_field as tff
from ibl_nerf_tpu_torch.kernels import fused_field_f64 as k1d
from ibl_nerf_tpu_torch.models import field as tfield
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.train import losses as tlosses
from ibl_nerf_tpu_torch.train import step as tstep
from ibl_nerf_tpu_torch.train.loop import train
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_train_step as ts  # noqa: E402
from make_synthetic_scene import make_scene  # noqa: E402
from test_torch_train_step import scene  # noqa: E402,F401  (the step's fixture)

torch.set_num_threads(2)

REL_FULL, REL_DENSITY = 1e-7, 2e-7
F64 = torch.float64


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


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tmap(fn, v) for v in tree]
    return fn(tree)


@functools.cache
def _setup(width):
    """f64 params from JAX's init, 64 x 64 points (two of the JAX kernel's
    tiles) and unit directions from a numpy seed, both packs, and JAX's
    kernel outputs."""
    kw = dict(depth=8, width=width, coarse_radiance_number=3)
    jcfg, tcfg = jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)
    jp = jax.jit(jfield.init_field_params, static_argnums=1)(jax.random.key(0), jcfg)
    np64 = jax.tree.map(lambda a: np.asarray(a).astype(np.float64), jp)
    tp = _tmap(lambda t: t.double(), field_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.5, 1.5, (64, 64, 3)).astype(np.float32)
    dirs = rng.standard_normal((64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    with _jax_x64():
        jpacked = jff.pack_field_weights(jax.tree.map(jnp.asarray, np64), jcfg,
                                         dtype=jnp.float64)
        ref_full = np.asarray(jff.fused_field_apply(jpacked, jnp.asarray(pts),
                                                    jnp.asarray(dirs), jcfg, interpret=True))
        ref_density = np.asarray(jff.fused_field_density(jpacked, jnp.asarray(pts), jcfg,
                                                         interpret=True))
        jpacked = jax.tree.map(np.asarray, jpacked)
    return dict(jcfg=jcfg, tcfg=tcfg, tp=tp, pts=pts, dirs=dirs, jpacked=jpacked,
                packed=tff.pack_field_weights(tp, tcfg, dtype=F64),
                ref_full=ref_full, ref_density=ref_density)


@pytest.fixture(scope="module", params=[32, 256], ids=["w32", "w256"])
def setup(request):
    return _setup(request.param)


def _plain(s, packed=None):
    packed = s["packed"] if packed is None else packed
    p, d = torch.from_numpy(s["pts"]), torch.from_numpy(s["dirs"])
    return (tff.fused_field_apply_plain(packed, p, d, s["tcfg"]).numpy(),
            tff.fused_field_density_plain(packed, p, s["tcfg"]).numpy())


def test_pack_matches_jax_pack_bit_for_bit(setup):
    """f64 matrices and biases exactly as JAX packs them (no trip through
    f32), minus its TPU-only padding; the embedding constants stay f32."""
    s = setup
    ref, out = s["jpacked"], s["packed"]
    assert sorted(out) == sorted(tff._WEIGHT_ORDER)
    n_out = 9 + 3 * s["tcfg"].coarse_radiance_number
    for k in tff._WEIGHT_ORDER:
        r = ref[k]
        if k in ("A", "B", "C", "D"):
            r = r[:, :n_out]
        elif k == "bias":
            r = r[0, :n_out]
        elif r.ndim == 2 and r.shape[0] == 1:
            r = r[0]
        want = torch.float32 if k.startswith("emb_") else F64
        assert out[k].dtype == want and r.dtype == out[k].numpy().dtype, k
        assert out[k].is_contiguous(), k
        np.testing.assert_array_equal(out[k].numpy(), r, err_msg=k)
    # a perturbation below f32's resolution survives the pack
    tp = _tmap(lambda t: t.clone(), s["tp"])
    tp["trunk"][3]["w"][0, 0] += 1e-12
    bumped = tff.pack_field_weights(tp, s["tcfg"], dtype=F64)
    assert float(bumped["w3"][0, 0] - s["packed"]["w3"][0, 0]) == pytest.approx(1e-12, rel=1e-3)


def test_plain_is_the_jax_kernel_given_its_sines(setup, monkeypatch):
    """With XLA's f32 sines in the embedding, the plain version equals the
    JAX kernel at f64 weights bit for bit: the same rounding points (f32
    embedding, f64 sums rounded to f32 before the f64 bias, the two-product
    layers and the heads summed in f32)."""
    s = setup

    def xla_sin(t):
        return torch.from_numpy(np.array(jnp.sin(jnp.asarray(t.numpy()))))

    monkeypatch.setattr(torch, "sin", xla_sin)
    full, density = _plain(s)
    assert full.dtype == density.dtype == np.float32
    assert full.shape == s["ref_full"].shape == (64, 64, 18)
    assert density.shape == s["ref_density"].shape == (64, 64, 1)
    np.testing.assert_array_equal(full, s["ref_full"])
    np.testing.assert_array_equal(density, s["ref_density"])


def test_plain_matches_the_jax_kernel(setup):
    s = setup
    full, density = _plain(s)
    assert _rel(full, s["ref_full"]) <= REL_FULL
    assert _rel(density, s["ref_density"]) <= REL_DENSITY


def test_f32_operands_fail_the_tolerance():
    """The negative control at width 256: the same field on f32 operands
    (an f32 pack of the same params through K1-f32's plain version) is
    outside both tolerances, so they tell the f64 rounding points apart."""
    s = _setup(256)
    packed32 = tff.pack_field_weights(s["tp"], s["tcfg"], dtype=torch.float32)
    full, density = _plain(s, packed32)
    assert _rel(full, s["ref_full"]) > REL_FULL
    assert _rel(density, s["ref_density"]) > REL_DENSITY


def test_cpu_wrappers_take_the_plain_f64_version(setup):
    s = setup
    packed, cfg = s["packed"], s["tcfg"]
    before = dict(tff.LAUNCHES)
    p, d = torch.from_numpy(s["pts"]), torch.from_numpy(s["dirs"])
    full = tff.fused_field_apply(packed, p, d, cfg)
    x = tff._pack_inputs(p, d)
    assert torch.equal(full.reshape(-1, 18), tff._field_plain_f64(packed, x, False))
    dens = tff.fused_field_density(packed, p, cfg)
    assert torch.equal(dens.reshape(-1, 1),
                       tff._field_plain_f64(packed, tff._pack_inputs(p, None), True))
    assert full.dtype == dens.dtype == torch.float32
    assert tff.LAUNCHES == before  # the plain version is no launch


def test_f64_pack_checks():
    """`_check` takes an f64 pack at width 256 and refuses a matrix of
    another dtype, an f64 embedding constant and other widths."""
    cfg = tfield.FieldConfig(depth=8, width=256, coarse_radiance_number=3)
    params = tfield.init_field_params(np.random.default_rng(0), cfg, "cpu")
    packed = tff.pack_field_weights(params, cfg, dtype=F64)
    x = tff._pack_inputs(torch.rand(5, 3), None)
    tff._check(packed, x, cfg)
    assert tff._packed_dtype(packed) == F64
    with pytest.raises(ValueError, match="f64"):
        tff._check(dict(packed, w5h=packed["w5h"].float()), x, cfg)
    with pytest.raises(ValueError, match="f32"):
        tff._check(dict(packed, emb_phase=packed["emb_phase"].double()), x, cfg)
    narrow = tfield.FieldConfig(depth=8, width=32, coarse_radiance_number=3)
    small = tff.pack_field_weights(
        tfield.init_field_params(np.random.default_rng(0), narrow, "cpu"), narrow, dtype=F64)
    with pytest.raises(ValueError, match="width"):
        tff._check(small, x, narrow)


@pytest.mark.parametrize("k", [0, 1, 3, 7, tff.MAX_COARSE])
def test_kernel_tiles_fit_shared_memory(k):
    """The source's shared-memory budget (its header: 174,080 B density,
    221,536 B full) for every head count the kernel takes: 64-point tiles
    in both variants, the full one's X (91 rows) + H (256) and two planes
    of the heads' f64 partial sums, which no longer grow with K (no P
    plane, no raw tile); one block an SM, under Hopper's 227 KB."""
    cfg = tfield.FieldConfig(depth=8, width=256, coarse_radiance_number=k)
    dens, full = k1d.smem_bytes(cfg, True), k1d.smem_bytes(cfg, False)
    if k == 3:
        assert (dens, full) == (174080, 221536)
    assert dens == 320 * 68 * 8
    assert full == 347 * 68 * 8 + 2 * 8 * 4 * 64 * 8
    assert max(dens, full) <= k1d.SMEM_LIMIT
    assert k1d.TILE == 64


def test_plan_constants_are_the_sources():
    """The Python mirror's constants are the source's."""
    src = (Path(tff.__file__).resolve().parent.parent / "csrc" / "fused_field_f64.cu").read_text()
    for name, value in (("kTile", k1d.TILE), ("kProjCols", k1d.PROJ_COLS),
                        ("kMmaK", k1d.MMA_K), ("kThreads", 32 * k1d.WARPS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert f"Projs {{\n  Proj p[3 + kMaxCoarse];" in src
    assert re.search(rf"constexpr int kMaxCoarse = {tff.MAX_COARSE};", src)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 7, tff.MAX_COARSE])
def test_projection_split_covers_each_column_once(k):
    """Every raw column lies in one projection, each of at most PROJ_COLS
    columns (the partial planes' width), and each projection's rows split
    into equal runs over its warps: A, B, C over 8 warps, head k of a pair
    over warps 0-3 or 4-7, an odd last head over all 8."""
    cols = [c for ranges in tff.projection_columns(k) for r in ranges for c in range(*r)]
    assert sorted(cols) == list(range(9 + 3 * k))
    for ranges in tff.projection_columns(k):
        assert sum(hi - lo for lo, hi in ranges) <= k1d.PROJ_COLS
    split = k1d.projection_split(k)
    assert split[:3] == [(0, 8)] * 3 and len(split) == 3 + k
    for i, (w0, nw) in enumerate(split[3:]):
        odd_last = k % 2 and i == k - 1
        assert (w0, nw) == ((0, 8) if odd_last else (4 * (i % 2), 4))
        assert (128 // nw) in (16, 32)


def _raw_by_split(packed, x, n_coarse, round_partials=False):
    """A model of the full variant's raw output: the activations as
    `_field_plain_f64` makes them, then each projection's rows split over
    its warps as `projection_split` says, each warp's partial an f64
    product, the partials summed in warp order in f64 and rounded to f32
    once (or, with `round_partials`, each rounded to f32 first and summed
    in f32), plus the f32 bias."""
    w, relu = packed, torch.relu

    def mm(a, b):
        return (a @ b).float()

    t = x @ w["emb_E"]
    emb = torch.where(w["emb_id"] > 0.0, t, torch.sin(t + w["emb_phase"])).double()
    tb = w["tb"]
    h = relu(mm(emb, w["w0"]) + tb[0])
    for i in (1, 2, 3, 4):
        h = relu(mm(h, w[f"w{i}"]) + tb[i])
    h = relu((mm(emb, w["w5x"]) + mm(h, w["w5h"])) + tb[5])
    for i in (6, 7):
        h = relu(mm(h, w[f"w{i}"]) + tb[i])
    pos_feat = relu(mm(h, w["wpf"]) + w["bpf"])
    feature = mm(h, w["wfeat"]) + w["bfeat"]
    h2 = relu((mm(feature, w["wv_f"]) + mm(emb, w["wv_d"])) + w["bv"])
    vf = relu(mm(h2, w["wcf"]) + w["bcf"])
    acts = [h, pos_feat, h2] + [vf[:, 128 * k:128 * (k + 1)] for k in range(n_coarse)]
    mats = [w["A"], w["B"], w["C"]] + [w["D"][128 * k:128 * (k + 1)] for k in range(n_coarse)]
    out = torch.empty((x.shape[0], w["bias"].shape[0]), dtype=torch.float32)
    for ranges, act, mat, (_, nw) in zip(tff.projection_columns(n_coarse), acts, mats,
                                         k1d.projection_split(n_coarse)):
        cols = [c for r in ranges for c in range(*r)]
        rows = act.shape[1] // nw
        parts = [act[:, rows * i:rows * (i + 1)] @ mat[rows * i:rows * (i + 1), cols]
                 for i in range(nw)]
        if round_partials:
            parts = [q.float() for q in parts]
        s = parts[0]
        for q in parts[1:]:
            s = s + q
        out[:, cols] = s.float() + w["bias"][cols].float()
    return out


def test_projection_split_is_the_plain_heads():
    """The full variant's head split (per-warp f64 partials summed in warp
    order, rounded to f32 once) gives `_field_plain_f64`'s raw output bit
    for bit at width 256, K = 3, on 4,096 points: only the order of the
    f64 sums differs. The negative control: the per-warp partials rounded
    to f32 before their sum differ from it in many elements."""
    s = _setup(256)
    x = tff._pack_inputs(torch.from_numpy(s["pts"]), torch.from_numpy(s["dirs"]))
    ref = tff._field_plain_f64(s["packed"], x, False)
    split = _raw_by_split(s["packed"], x, 3)
    assert split.shape == ref.shape == (4096, 18)
    assert torch.equal(split, ref)
    rounded = _raw_by_split(s["packed"], x, 3, round_partials=True)
    off = int((rounded != ref).sum())
    assert off > 100, off
    # ... though not by enough for the relative-norm gate to see it
    assert _rel(rounded.numpy(), ref.numpy()) <= REL_FULL


# ---------------------------------------------------------------------------
# The renderer, the train step and the CLIs under compute_dtype float64 +
# use_pallas: K1-f64 on the no-grad sweeps (ε-offset density sweeps,
# reflected march), the gradient path eager f64, as in JAX.
# ---------------------------------------------------------------------------

FIELD = dict(depth=8, width=32, coarse_radiance_number=3)
BASE = dict(n_samples=8, n_importance=8, perturb=False, approximate_radiance=True,
            normal_type="normal_map_from_depth_gradient_epsilon",
            correct_depth_for_prefiltered_radiance_infer=True)
# Both sides round K1's raw to f32 at the same points and differ only by
# an ulp of some f32 sines. The ε-normals are differences of K1's f32
# densities over ε, which amplify that ulp: the worst map on these inputs
# (the coarse pass's ε-normal) sits 1.3e-6 from JAX's, every other one
# below 9e-7. Every map within atol 5e-6 and rtol 1e-6, 100x below the f32
# bounds of tests/test_torch_renderer.py (5e-4 / 1e-3 basic, 2e-3 / 5e-3
# shaded).
RENDER_ATOL, RENDER_RTOL = 5e-6, 1e-6


def _cfgs(**kw):
    jr = JRenderConfig(field=jfield.FieldConfig(**FIELD), **BASE).replace(**kw)
    fields = {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)}
    for name in ("field", "field_fine"):
        if fields[name] is not None:
            fields[name] = tfield.FieldConfig(**dataclasses.asdict(fields[name]))
    return jr, RenderConfig(**fields)


@pytest.fixture(scope="module")
def render_setup():
    jcfg = jfield.FieldConfig(**FIELD)
    k1, k2 = jax.random.split(jax.random.key(5))
    jvars = {"coarse": jfield.init_field_params(k1, jcfg),
             "fine": jfield.init_field_params(k2, jcfg)}
    for v in jvars.values():  # visible density, so depth and normals mean something
        v["sigma"]["b"] = v["sigma"]["b"] + 0.5
    rng = np.random.default_rng(4)
    return dict(jvars=jax.tree.map(np.asarray, jvars), lut=np.asarray(j_lut()),
                rays_o=(rng.standard_normal((8, 3)) * 0.1).astype(np.float32),
                rays_d=rng.standard_normal((8, 3)).astype(np.float32))


def render_f64_both(s, **kw):
    """JAX's and the port's maps (numpy) of one f64 render_rays call with
    K1 on the no-grad sweeps, and the port's K1 calls by dtype and variant."""
    jr, tr = _cfgs(compute_dtype="float64", use_pallas=True, **kw)
    ro, rd = s["rays_o"].astype(np.float64), s["rays_d"].astype(np.float64)
    with _jax_x64():
        jvars = jax.tree.map(lambda a: jnp.asarray(a.astype(np.float64)), s["jvars"])
        ref = jax.jit(lambda b: j_render_rays(
            jax.random.key(0), jvars, {"brdf_lut": jnp.asarray(s["lut"].astype(np.float64))},
            b, jr))(j_batch(jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0))
        ref = {k: np.asarray(v) for k, v in ref.items()}
    tvars = _tmap(lambda t: t.double(), field_params_from_numpy(s["jvars"], "cpu"))
    calls = []
    run = tff._run

    def counting_run(packed, x, cfg, density_only, *heads):
        calls.append((tff._packed_dtype(packed), density_only))
        return run(packed, x, cfg, density_only, *heads)

    tff._run = counting_run
    try:
        out = render_rays(tvars, {"brdf_lut": load_brdf_lut(device="cpu").double()},
                          make_ray_batch(torch.from_numpy(ro), torch.from_numpy(rd), 2.0, 6.0),
                          tr)
    finally:
        tff._run = run
    return ref, {k: v.numpy() for k, v in out.items()}, calls


@pytest.mark.parametrize("coarse_shading", [True, False], ids=["coarse", "fast"])
def test_render_rays_matches_jax(render_setup, coarse_shading):
    """Every map of JAX's, of its dtype, within RENDER_ATOL / RENDER_RTOL;
    the no-grad sweeps went through K1 at f64 weights: per shading pass one
    density call for the ε-offset sweep and one full call for the
    reflected march."""
    ref, out, calls = render_f64_both(render_setup, coarse_shading=coarse_shading)
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert out[k].dtype == r.dtype and out[k].shape == r.shape, k
        np.testing.assert_allclose(out[k], r, atol=RENDER_ATOL, rtol=RENDER_RTOL, err_msg=k)
    assert calls == [(F64, True), (F64, False)] * (2 if coarse_shading else 1)


def test_train_step_matches_jax(scene):
    """A float64 + use_pallas train step (ε normals, K1-f64 on the
    reflected march; f32 params, as the trainer keeps them) against JAX's
    make_train_step's loss and gradients, JAX under x64 and the port fed
    JAX's draws of that mode: int64 pixel indices, the stratified jitter
    in the f32 rays' dtype, the importance uniforms in the f64 cdf's.
    Measured: the loss 6e-9 and the groups' gradients 3.2e-7 and 9.8e-8
    from JAX's (an ulp of K1's f32 raw, through the reflected march);
    held to 1e-7 and 1e-6 relative."""
    jv, tv = ts._variables(4)
    key = jax.random.key(5)
    with _jax_x64():
        draws = ts._step_draws(key)
        k_strat = jax.random.split(jax.random.split(key, 5)[1], 4)[0]
        draws["render"]["strat"] = torch.from_numpy(np.array(
            jax.random.uniform(k_strat, (ts.B, ts.S), dtype=jnp.float32)))
        assert draws["render"]["pdf"].dtype == F64
        loss_rel, grad_rels = _step_both(scene, jv, tv, key, draws)
    assert loss_rel <= 1e-7
    for group, rel in grad_rels.items():
        assert rel <= 1e-6, (group, rel)


def _step_both(scene, jv, tv, key, draws):
    jarr, tarr, jc, tc = scene
    jr, tr = ts._cfgs(4, normal_type=ts.EPS, compute_dtype="float64", use_pallas=True)
    jl, tl = jlosses.LossConfig(**ts.LOSS), tlosses.LossConfig(**ts.LOSS)
    jph, tph = jlosses.resolve_phase(50000, jl), tlosses.resolve_phase(50000, tl)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        ts._jax_loss_fn(jr, jarr, jc, jl, jph), has_aux=True))(jv, key)
    opt = tstep.build_optimizer(tv, lrate=5e-4, lrate_decay=500, lcfg=tl)
    state = tstep.init_train_state(tv, opt)
    step = tstep.make_train_step(tr, tl, tph, opt, tc, ts.H, ts.W, ts.B, 0.7,
                                 ts.NEAR, ts.FAR)
    loss, _, grads = step.loss_and_grads(state.variables, tarr, draws)
    rels = {}
    for group in ("coarse", "fine"):
        got = np.concatenate([g.reshape(-1).numpy() for g in tstep._leaves(grads[group])])
        ref = np.concatenate([np.asarray(x, np.float64).reshape(-1)
                              for x in jax.tree.leaves(jgrads[group])])
        rels[group] = _rel(got, ref)
    return abs(float(loss) - float(jloss)) / abs(float(jloss)), rels


def test_cli_train_and_test_run_the_mode(tmp_path):
    """cli.train at depth 8, width 32 under float64 + use_pallas runs
    through the phase switch to its checkpoints with finite losses, and
    cli.test renders the test split from the last one."""
    scene_dir = make_scene(str(tmp_path / "scene"))
    argv = ["--datadir", scene_dir, "--basedir", str(tmp_path / "logs"), "--expname", "exp",
            "--netdepth", "8", "--netwidth", "32", "--N_rand", "16", "--N_samples", "8",
            "--N_importance", "8", "--coarse_radiance_number", "2",
            "--load_depth_range_from_file", "--render_factor", "4", "--testskip", "1",
            "--compute_dtype", "float64", "--use_pallas"]
    state = train(parse_with_includes(argv + [
        "--N_iter", "4", "--N_iter_ignore_approximated_radiance", "2", "--i_weights", "4",
        "--i_testset", "100", "--summary_step", "1"]), device="cpu")
    assert state.step == 5
    logdir = tmp_path / "logs" / "exp"
    assert (logdir / "ckpt_000004").exists()
    with open(logdir / "metrics.jsonl") as f:
        losses = [r["loss_total"] for r in map(json.loads, f) if "loss_total" in r]
    assert len(losses) == 5 and np.isfinite(losses).all()
    out = cli_test.main(argv, device="cpu")
    assert out is not None
