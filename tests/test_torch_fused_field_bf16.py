"""K1's bf16-weight variant: its plain PyTorch version against the JAX
Pallas kernel, the bf16 packing, the wrappers' dispatch on the packed
dtype, the slab stream of the density variant, and the CUDA kernel's plan
(kernels/fused_field_bf16.py): its shared-memory layout, its budget, its
input checks, and a plain model of its dataflow over 128-point tiles.

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
against this plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.kernels import fused_field as jff
from ibl_nerf_tpu.models import field as jfield
from ibl_nerf_tpu_torch.kernels import fused_field as tff
from ibl_nerf_tpu_torch.kernels import fused_field_bf16 as k1b
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
    with pytest.raises(ValueError, match="f32, bf16 or f64"):
        tff.fused_field_density(tff.pack_field_weights(params, cfg, dtype=torch.float16),
                                pts, cfg)
    # f64, refused until K1 had its f64 kernel, computes
    # (tests/test_torch_fused_field_f64.py holds it to JAX's)
    dens = tff.fused_field_density(tff.pack_field_weights(params, cfg, dtype=torch.float64),
                                   pts, cfg)
    assert dens.shape == (5, 1) and dens.dtype == torch.float32
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
    then A in one narrow slab: 65 slabs, as `density_slab_count` in
    csrc/fused_field_bf16.cu counts (h0 4, h1..h4 32, h5 4 + 8, h6 and h7
    16, A 1)."""
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


def _stream_model(x, w16, emb, slabs, density_only):
    """csrc/wgmma_field.cuh's dataflow (K1 at bf16 weights, K2) in PyTorch: per 128-point tile two
    warpgroups of 64 points, each consuming the whole slab stream in the
    producer's order (`stream_order`) and keeping its activations as bf16
    k-blocks of 64 x 32 in its own shared-memory region (H, P, X, as
    `act_blocks` places them; vf through P one 256-column pass at a time).
    A pass sums, k-block after k-block, the f32 products with the first N
    rows of one wide slab each; a head sums a narrow slab's [32][32] blocks
    in turn; the epilogue adds the bias, applies relu (not for ft) and
    rounds to bf16; the heads accumulate in f32 from A and B, then C, then
    D a vf pass at a time. K2's residual stores read the buffer an
    epilogue just wrote (H after each trunk layer and hv, P after pf and
    ft), in program order. Returns raw (n, 1) or (n, 9+3K) f32 and, for
    the full variant, the stored planes (11, n, 256) bf16."""
    bf, rows = torch.bfloat16, k1b.ROWS
    n, n_out, vf_cols = x.shape[0], w16["bias"].shape[0], w16["wcf"].shape[1]
    order = k1b.stream_order(slabs.shape[0], vf_cols, density_only)
    blocks = k1b.act_blocks(density_only)
    H, X = blocks["H"][0], blocks["X"][0]
    P = blocks.get("P", (None,))[0]
    n_blocks = sum(b for _, b in blocks.values())
    out, planes = [], []
    for base in range(0, n, rows):   # a warpgroup's 64 points of a tile
        xt = torch.zeros((rows, x.shape[1]))
        xt[:min(rows, n - base)] = x[base:base + rows]
        region = torch.full((n_blocks, rows, tfft.SLAB_K), float("nan"), dtype=bf)
        ring = iter(slabs[order])

        def read(first, cols):
            return torch.cat([region[first + b] for b in range(cols // tfft.SLAB_K)], dim=1)

        def write(first, v):
            for j in range(v.shape[1] // tfft.SLAB_K):
                region[first + j] = v[:, j * 32:(j + 1) * 32]

        def products(ops, n_cols, narrow, acc):
            for first, k_blocks in ops:
                for kb in range(k_blocks):
                    if not narrow or kb % (tfft.NARROW_K // tfft.SLAB_K) == 0:
                        slab = next(ring)
                    b = slab[(kb % 8) * 32:(kb % 8 + 1) * 32] if narrow else slab
                    acc = acc + region[first + kb].float() @ b[:n_cols].float().t()
            return acc

        def layer(ops, dst, n_cols, bias, relu=True):
            v = products(ops, n_cols, False, torch.zeros((rows, n_cols))) + bias.float()
            write(dst, (torch.relu(v) if relu else v).to(bf))

        stored = []

        def store(first):   # a residual plane from the buffer as it is now
            stored.append(read(first, 256).clone())

        write(X, tfft._embed(xt, emb).to(bf))
        tb = w16["tb"]
        layer([(X, 4)], H, 256, tb[0])
        store(H)
        for i in range(1, 8):
            layer([(X, 4), (H, 8)] if i == 5 else [(H, 8)], H, 256, tb[i])
            store(H)
        if density_only:
            o = products([(H, 8)], 8, True, torch.zeros((rows, 8)))
            raw = o[:, :1] + w16["bias"][0].float()
        else:
            layer([(H, 8)], P, 256, w16["bpf"])                          # pf
            store(P)
            o = products([(H, 8), (P, 8)], k1b.HEAD_N, True,
                         torch.zeros((rows, k1b.HEAD_N)))                # h7@A + pf@B
            layer([(H, 8)], P, 256, w16["bfeat"], relu=False)            # ft
            store(P)
            layer([(P, 8), (X, 4)], H, 256, w16["bv"])                   # hv
            store(H)
            o = products([(H, 8)], k1b.HEAD_N, True, o)                  # + hv@C
            for c0 in range(0, vf_cols, 256):                            # vf into P
                cols = min(256, vf_cols - c0)
                layer([(H, 8)], P, cols, w16["bcf"][c0:c0 + cols])
                o = products([(P, cols // 32)], k1b.HEAD_N, True, o)     # + vf@D
            raw = o[:, :n_out] + w16["bias"].float()
        assert next(ring, None) is None   # the warpgroup used the whole stream
        assert not read(H, 256).isnan().any()
        out.append(raw[:min(rows, n - base)])
        planes.append(torch.stack(stored)[:, :min(rows, n - base)])
    return torch.cat(out), (None if density_only else torch.cat(planes, dim=1))


def _model_case(n, k, density_only):
    w16, _ = _shapes(k)
    rng = np.random.default_rng(n)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (n, 1, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    x = tff._pack_inputs(pts, None if density_only else dirs)
    emb = tfft.emb_constants(tfield.FieldConfig(coarse_radiance_number=k), "cpu")
    slabs = (tfft.density_slabs if density_only else tfft.forward_slabs)(w16)
    got, planes = _stream_model(x, w16, emb, slabs, density_only)
    want = tfft.field_bf16_plain(x, w16, emb, density_only)
    assert got.shape == want.shape == (n, 1 if density_only else 9 + 3 * k)
    assert _rel(got.numpy(), want.numpy()) <= REL
    if not density_only:   # K2's residual planes, stored from the activations
        _, res = tfft.train_forward_plain(x, w16, emb)
        assert planes.shape == res.shape == (len(tfft._RES_ORDER), n, 256)
        for i, name in enumerate(tfft._RES_ORDER):
            assert _rel(planes[i].float().numpy(), res[i].float().numpy()) <= REL, name


@pytest.mark.parametrize("n", [1, 63, 127, 129, 130, 300])
def test_executing_the_density_stream_gives_the_plain_density(n):
    _model_case(n, 3, density_only=True)


@pytest.mark.parametrize("n,k", [(1, 3), (127, 3), (129, 3), (300, 3), (129, 1), (129, 0),
                                 (129, 4), (129, 7), (300, 7)])
def test_executing_the_full_stream_gives_the_plain_field(n, k):
    """The full variant's dataflow at K = 3 (vf in a 256- and a 128-column
    pass, D over two narrow slabs), 1 and 0 (one 128-column pass), 4 (two
    256-column passes) and 7 (30 head columns; vf in three 256-column
    passes and a 128-column one); with K2's residual planes as its stores
    read them (ft leaves P before vf's passes overwrite it)."""
    _model_case(n, k, density_only=False)


# ---------------------------------------------------------------------------
# The CUDA kernel's plan: layout, budget, checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols", [(k1b.ROWS, 256), (k1b.ROWS, 640),
                                       (tfft.SLAB_N, tfft.SLAB_K)],
                         ids=["activations_h", "activations_full_region", "slab"])
def test_swizzled_layout_is_a_bijection(rows, cols):
    """Every bf16 element of a warpgroup's activations (H alone; the full
    variant's H, P and X) or of a ring stage gets its own two bytes, the
    buffer is covered, and each 16-byte chunk stays in its own 64-byte row
    of its k-block: the swizzle only permutes chunks within a row."""
    offs = np.array([[k1b.sw64_offset(r, c) for c in range(cols)] for r in range(rows)])
    assert sorted(offs.ravel()) == list(range(0, 2 * rows * cols, 2))
    kblock = np.arange(cols)[None, :] // tfft.SLAB_K
    row = np.arange(rows)[:, None]
    assert np.array_equal(offs // 64, kblock * rows + row)
    # within a row, 8 consecutive columns are one 16-byte chunk, in order
    assert np.array_equal(offs % 16, (np.arange(cols)[None, :] % 8 * 2).repeat(rows, 0))


@pytest.mark.parametrize("density_only", [True, False], ids=["density", "full"])
@pytest.mark.parametrize("k", [0, 1, 3, 4, 7])
def test_shared_memory_budget_fits(density_only, k):
    """A block of either variant fits the card's 232,448 bytes at K = 0 to
    7: vf goes through P a 256-column pass at a time and the heads fit one
    narrow slab, so the budget does not grow with K."""
    assert k1b.smem_bytes(density_only) <= k1b.SMEM_LIMIT
    assert 9 + 3 * k <= k1b.HEAD_N
    blocks = k1b.act_blocks(density_only)
    spans = sorted(blocks.values())
    assert spans[0][0] == 0 and all(a + n == b for (a, n), (b, _) in zip(spans, spans[1:]))
    if not density_only:   # one vf pass fills P
        assert blocks["P"][1] * tfft.SLAB_K == tfft.SLAB_N


@pytest.mark.parametrize("k", [0, 1, 3, 4, 7])
def test_stream_order_takes_each_vf_pass_then_its_slab_of_d(k):
    """The full variant's copy order is a permutation of the stream: the
    stream as laid out up to hv, then C, then per vf pass its slabs of wcf
    followed by the narrow slab of D holding that pass's rows."""
    w16, shapes = _shapes(k)
    sched, total = tfft.forward_schedule(shapes)
    order = k1b.stream_order(total, w16["wcf"].shape[1], density_only=False)
    assert sorted(order) == list(range(total))
    assert k1b.stream_order(total, 128, density_only=True) == list(range(total))
    at = {w: (first, stride) for w, _, _, _, first, stride in sched}
    vf_first, c = at["wcf"][0], at["C"][0]
    assert order[:vf_first] == list(range(vf_first)) and order[vf_first] == c
    passes = -(-w16["wcf"].shape[1] // tfft.SLAB_N)
    rest = order[vf_first + 1:]
    for p in range(passes):
        step = rest[9 * p:9 * (p + 1)]
        assert step[:8] == [vf_first + at["wcf"][1] * p + s for s in range(8)]
        assert step[8] == at["D"][0] + p


def test_plan_constants_are_the_sources():
    """The mirror's tile, ring and alignment are the ones
    csrc/fused_field_bf16.cu and K2 compile (read from the text of the
    field chain they share, csrc/wgmma_field.cuh), so the layout and budget
    tests above hold for the kernels themselves."""
    import pathlib
    import re

    csrc = pathlib.Path(tfft.__file__).parent.parent / "csrc"
    src = (csrc / "wgmma_field.cuh").read_text()
    for user in ("fused_field_bf16.cu", "fused_field_train.cu"):
        assert '#include "wgmma_field.cuh"' in (csrc / user).read_text(), user

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))

    assert (const("kRows"), const("kGroups"), const("kAlign")) == (k1b.ROWS, k1b.GROUPS,
                                                                   k1b.ALIGN)
    stages = re.search(r"ring_stages\(bool density\) \{ return density \? (\d+) : (\d+);", src)
    assert tuple(map(int, stages.groups())) == (k1b.ring_stages(True), k1b.ring_stages(False))
    assert "constexpr int kHeadN = kNarrowN;" in src and k1b.HEAD_N == tfft.NARROW_N


def test_bf16_kernel_checks_raise():
    """What the launcher checks before a CUDA launch: bf16 weights, width
    256, f32 embedding, (N, 8) f32 input, and at most 7 coarse heads (the
    heads' 9 + 3K columns fit one narrow slab)."""
    w16, _ = _shapes(3)
    emb = tfft.emb_constants(tfield.FieldConfig(), "cpu")
    x = tff._pack_inputs(torch.rand(5, 3), None)
    k1b.check(x, w16, emb, density_only=True)
    k1b.check(x, w16, emb, density_only=False)
    with pytest.raises(ValueError, match="bf16"):
        k1b.check(x, dict(w16, w3=w16["w3"].float()), emb, True)
    with pytest.raises(ValueError, match="f32"):
        k1b.check(x, w16, dict(emb, E=emb["E"].to(BF16)), True)
    with pytest.raises(ValueError, match="kernel input"):
        k1b.check(x[:, :6].contiguous(), w16, emb, True)
    narrow = tfield.FieldConfig(depth=8, width=32, coarse_radiance_number=1)
    small = tff.pack_field_weights(
        tfield.init_field_params(np.random.default_rng(0), narrow, "cpu"), narrow, dtype=BF16)
    with pytest.raises(ValueError, match="width"):
        k1b.check(x, small, tfft.emb_constants(narrow, "cpu"), True)
    for k in (4, 7):
        wk, _ = _shapes(k)
        k1b.check(x, wk, emb, density_only=True)
        k1b.check(x, wk, emb, density_only=False)
    w8, _ = _shapes(8)
    for density_only in (True, False):
        with pytest.raises(ValueError, match="coarse heads"):
            k1b.check(x, w8, emb, density_only)
