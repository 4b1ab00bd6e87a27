"""K1's bf16-weight variant: its plain PyTorch version against the JAX
Pallas kernel, the bf16 packing, the wrappers' dispatch on the packed
dtype, and the slab stream of the density variant.

The JAX side runs `fused_field_apply` / `fused_field_density` on
`pack_field_weights(..., dtype=jnp.bfloat16)` in interpret mode, as
tests/test_kernels.py runs the kernel. Both sides round where the kernel
does (the embedding to bf16, each layer to bf16 after its f32 sum, bias
and relu; raw in f32) and differ only in the order of the f32 sums, so a
hidden unit near a bf16 rounding tie can land on the neighbouring value
(2^-8 relative) and carry that into the later layers: outputs are held
within 2e-3 relative norm, the bound tests/test_torch_fused_field_train.py
holds K2 to; a wrong weight, rounding point or head moves them by O(1).
The CUDA kernel runs only on the card, where chip_smoke.py holds it
against this plain version and against K2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.kernels import fused_field as jff
from ibl_nerf_tpu.models import field as jfield
from ibl_nerf_tpu_torch.kernels import fused_field as tff
from ibl_nerf_tpu_torch.kernels import fused_field_train as tfft
from ibl_nerf_tpu_torch.models import field as tfield
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

torch.set_num_threads(2)

REL = 2e-3
BF16 = torch.bfloat16


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def _setup(width, k=3, seed=0):
    kw = dict(depth=8, width=width, coarse_radiance_number=k)
    jcfg, tcfg = jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)
    jp = jax.jit(jfield.init_field_params, static_argnums=1)(jax.random.key(seed), jcfg)
    tp = field_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed + 1)
    # 7 x 19 = 133 points: not a multiple of any tile
    pts = rng.uniform(-1.5, 1.5, (7, 19, 3)).astype(np.float32)
    dirs = rng.standard_normal((7, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dict(jcfg=jcfg, tcfg=tcfg, pts=pts, dirs=dirs,
                jpacked=jff.pack_field_weights(jp, jcfg, dtype=jnp.bfloat16),
                packed=tff.pack_field_weights(tp, tcfg, dtype=BF16))


@pytest.fixture(scope="module", params=[32, 256], ids=["w32", "w256"])
def setup(request):
    return _setup(request.param)


def test_full_variant_matches_jax_kernel(setup):
    s = setup
    ref = jff.fused_field_apply(s["jpacked"], jnp.asarray(s["pts"]), jnp.asarray(s["dirs"]),
                                s["jcfg"], interpret=True)
    out = tff.fused_field_apply_plain(s["packed"], torch.from_numpy(s["pts"]),
                                      torch.from_numpy(s["dirs"]), s["tcfg"])
    assert out.shape == ref.shape == (7, 19, 18) and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= REL


def test_density_variant_matches_jax_kernel(setup):
    s = setup
    ref = jff.fused_field_density(s["jpacked"], jnp.asarray(s["pts"]), s["jcfg"],
                                  interpret=True)
    out = tff.fused_field_density_plain(s["packed"], torch.from_numpy(s["pts"]), s["tcfg"])
    assert out.shape == ref.shape == (7, 19, 1) and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= REL


def test_density_is_the_full_variants_sigma(setup):
    """The density variant runs the same trunk; column 0 of the heads B,
    C and D is zero, so its sigma is the full variant's up to the order of
    an f32 sum."""
    s = setup
    pts = torch.from_numpy(s["pts"])
    full = tff.fused_field_apply_plain(s["packed"], pts, torch.from_numpy(s["dirs"]),
                                       s["tcfg"])
    dens = tff.fused_field_density_plain(s["packed"], pts, s["tcfg"])
    np.testing.assert_allclose(dens.numpy(), full[..., :1].numpy(), rtol=1e-5, atol=1e-6)


def test_pack_matches_jax_pack(setup):
    """bf16 matrices and biases bit for bit like the JAX packing, minus
    its TPU-only padding (128-lane output columns, the 2-D bias lift);
    the embedding constants stay f32."""
    s = setup
    ref = jax.tree.map(np.asarray, s["jpacked"])
    out = s["packed"]
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
        want = torch.float32 if k.startswith("emb_") else BF16
        assert out[k].dtype == want and out[k].is_contiguous(), k
        np.testing.assert_array_equal(out[k].float().numpy(), r.astype(np.float32),
                                      err_msg=k)


def test_cpu_wrappers_take_the_plain_version(setup):
    s = setup
    packed, cfg = s["packed"], s["tcfg"]
    before = dict(tff.LAUNCHES)
    p, d = torch.from_numpy(s["pts"]), torch.from_numpy(s["dirs"])
    x = tff._pack_inputs(p, d)
    emb = tfft.emb_constants(cfg, "cpu")
    full = tff.fused_field_apply(packed, p, d, cfg)
    assert torch.equal(full, tff.fused_field_apply_plain(packed, p, d, cfg))
    assert torch.equal(full.reshape(-1, 18), tfft.field_bf16_plain(x, packed, emb, False))
    dens = tff.fused_field_density(packed, p, cfg)
    assert torch.equal(dens, tff.fused_field_density_plain(packed, p, cfg))
    assert torch.equal(dens.reshape(-1, 1),
                       tfft.field_bf16_plain(tff._pack_inputs(p, None), packed, emb, True))
    assert tff.LAUNCHES == before  # the plain version is no launch


def test_bad_dtypes_and_widths_raise():
    cfg = tfield.FieldConfig(depth=8, width=256, coarse_radiance_number=1)
    params = tfield.init_field_params(np.random.default_rng(0), cfg, "cpu")
    packed = tff.pack_field_weights(params, cfg, dtype=BF16)
    pts = torch.rand(5, 3)
    x = tff._pack_inputs(pts, None)
    tff._check(packed, x, cfg)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="f32 or bf16"):
            tff.fused_field_density(tff.pack_field_weights(params, cfg, dtype=dt), pts, cfg)
    with pytest.raises(ValueError, match="bf16"):   # one matrix left in f32
        tff._check(dict(packed, w3=packed["w3"].float()), x, cfg)
    with pytest.raises(ValueError, match="f32"):    # the embedding must stay f32
        tff._check(dict(packed, emb_E=packed["emb_E"].to(BF16)), x, cfg)
    narrow = tfield.FieldConfig(depth=8, width=32, coarse_radiance_number=1)
    small = tff.pack_field_weights(
        tfield.init_field_params(np.random.default_rng(0), narrow, "cpu"), narrow, dtype=BF16)
    with pytest.raises(ValueError, match="width"):
        tff._check(small, x, narrow)
    with pytest.raises(ValueError, match="width"):
        tfft._check(x, small, tfft.emb_constants(narrow, "cpu"), 12)


# ---------------------------------------------------------------------------
# The density variant's slab stream (pure Python; the kernel runs it on the card)
# ---------------------------------------------------------------------------

TILE = 64  # points per block of k1_bf16_forward


def _shapes(k):
    """bf16 packed weights at 8x256 with K coarse radiance lobes, and
    their shapes."""
    cfg = tfield.FieldConfig(depth=8, width=256, coarse_radiance_number=k)
    params = tfield.init_field_params(np.random.default_rng(k), cfg, "cpu")
    w16 = tff.pack_field_weights(params, cfg, dtype=BF16)
    return w16, tfft._shapes(w16)


def _slab_b(slab, n):
    """One slab as the B block [columns][reduction rows] it holds."""
    sn, sk = tfft.slab_dims(n)
    return slab.reshape(sk // tfft.SLAB_K, sn, tfft.SLAB_K).transpose(0, 1).reshape(sn, sk)


@pytest.mark.parametrize("k", [1, 3])
def test_density_schedule_is_the_trunk_then_sigmas_head(k):
    """The stream holds the trunk's weights where K2's stream holds them,
    then A in one narrow slab: 65 slabs, as `density_slab_count` counts
    (h0 4, h1..h4 32, h5 4 + 8, h6 and h7 16, A 1)."""
    w16, shapes = _shapes(k)
    sched, total = tfft.density_schedule(shapes)
    fwd, _ = tfft.forward_schedule(shapes)
    trunk = [op for op in fwd if op[0] in ("w0", "w1", "w2", "w3", "w4", "w5x", "w5h",
                                             "w6", "w7")]
    assert sched[:-1] == tuple(trunk)
    w, t, n, kk, first, stride = sched[-1]
    assert (w, t, n, kk) == ("A", True, 9 + 3 * k, 256)
    assert tfft.slab_dims(n) == (tfft.NARROW_N, tfft.NARROW_K)
    assert first == total - 1 == 64 and stride == 1


@pytest.mark.parametrize("k", [1, 3])
def test_density_slabs_round_trip(k):
    w16, shapes = _shapes(k)
    slabs = tfft.density_slabs(w16)
    sched, total = tfft.density_schedule(shapes)
    assert slabs.shape == (total, tfft.SLAB_N, tfft.SLAB_K)
    for w, t, n, kk, first, stride in sched:
        sn, sk = tfft.slab_dims(n)
        b = torch.cat([torch.cat([_slab_b(slabs[first + p * stride + s], n)
                                  for s in range(-(-kk // sk))], dim=1)
                       for p in range(-(-n // sn))])
        assert torch.equal(b[:n, :kk], w16[w].t()), w
    # nothing but the weights: every other element is padding, zero
    assert int((slabs != 0).sum()) == int(sum((w16[w] != 0).sum() for w, *_ in sched))


def _stream_density(x, w16, emb, slabs):
    """The density variant as `k1_bf16_forward<true>` runs it: per 64-point
    tile the trunk's layers, each pass summing its operands' slabs in
    stream order in f32, then bias, relu and bf16; then h7 against A's
    narrow slab, column 0, plus bias[0]."""
    bf = torch.bfloat16
    out = []
    for base in range(0, x.shape[0], TILE):
        xt = torch.zeros((TILE, x.shape[1]))
        xt[:min(TILE, x.shape[0] - base)] = x[base:base + TILE]
        ring = iter(slabs)

        def layer(ops, bias):
            acc = torch.zeros((TILE, tfft.SLAB_N))
            for a in ops:
                for k0 in range(0, a.shape[1], tfft.SLAB_K):
                    acc += a[:, k0:k0 + tfft.SLAB_K].float() @ next(ring).float().t()
            return torch.relu(acc + bias.float()).to(bf)

        xe = tfft._embed(xt, emb).to(bf)
        tb = w16["tb"]
        h = layer([xe], tb[0])
        for i in range(1, 8):
            h = layer([xe, h] if i == 5 else [h], tb[i])
        a = _slab_b(next(ring), w16["A"].shape[1]).float()
        assert next(ring, None) is None   # the tile used the whole stream
        sigma = h.float() @ a[0] + w16["bias"][0].float()
        out.append(sigma[:min(TILE, x.shape[0] - base), None])
    return torch.cat(out)


@pytest.mark.parametrize("n", [1, 63, 130])
def test_executing_the_density_stream_gives_the_plain_density(n):
    w16, _ = _shapes(3)
    rng = np.random.default_rng(n)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32))
    x = tff._pack_inputs(pts, None)
    emb = tfft.emb_constants(tfield.FieldConfig(), "cpu")
    got = _stream_density(x, w16, emb, tfft.density_slabs(w16))
    want = tfft.field_bf16_plain(x, w16, emb, density_only=True)
    assert got.shape == want.shape == (n, 1)
    assert _rel(got.numpy(), want.numpy()) <= REL
