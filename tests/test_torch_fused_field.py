"""K1's plain PyTorch version against the JAX Pallas kernel.

The JAX side runs `fused_field_apply` / `fused_field_density` in
interpret mode, as tests/test_kernels.py does. Both sides compute the
embedding as sin(t + phase) from the same packed weights; tolerance
atol 2e-5 / rtol 1e-4, the bound tests/test_kernels.py holds the JAX
kernel to. The CUDA kernel itself runs only on the card, where
chip_smoke.py holds it against this plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.kernels import fused_field as jff
from ibl_nerf_tpu.models import field as jfield
from ibl_nerf_tpu.ops.embedding import positional_encoding as jpe
from ibl_nerf_tpu_torch.kernels import fused_field as tff
from ibl_nerf_tpu_torch.models import field as tfield
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

torch.set_num_threads(2)


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
    return jcfg, tcfg, jp, tp, pts, dirs


@pytest.fixture(scope="module", params=[32, 256], ids=["w32", "w256"])
def setup(request):
    return _setup(request.param)


def test_full_variant_matches_jax_kernel(setup):
    jcfg, tcfg, jp, tp, pts, dirs = setup
    ref = jff.fused_field_apply(jff.pack_field_weights(jp, jcfg), jnp.asarray(pts),
                                jnp.asarray(dirs), jcfg, interpret=True)
    packed = tff.pack_field_weights(tp, tcfg)
    out = tff.fused_field_apply_plain(packed, torch.from_numpy(pts),
                                      torch.from_numpy(dirs), tcfg)
    assert out.shape == ref.shape == (7, 19, 18)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_density_variant_matches_jax_kernel(setup):
    jcfg, tcfg, jp, tp, pts, _ = setup
    ref = jff.fused_field_density(jff.pack_field_weights(jp, jcfg),
                                  jnp.asarray(pts), jcfg, interpret=True)
    packed = tff.pack_field_weights(tp, tcfg)
    out = tff.fused_field_density_plain(packed, torch.from_numpy(pts), tcfg)
    assert out.shape == ref.shape == (7, 19, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_plain_matches_eager_field(setup):
    """The kernel's math (sin(t + π/2) embedding, packed heads) equals
    the eager field (cos embedding, concatenated skip)."""
    jcfg, tcfg, _, tp, pts, dirs = setup
    packed = tff.pack_field_weights(tp, tcfg)
    pe = torch.from_numpy(np.array(jpe(jnp.asarray(pts), jcfg.multires)))
    de = torch.from_numpy(np.array(jpe(jnp.asarray(dirs), jcfg.multires_views)))
    ref = tfield.apply_field(tp, pe, de[:, None, :].expand(7, 19, -1), tcfg)
    out = tff.fused_field_apply_plain(packed, torch.from_numpy(pts),
                                      torch.from_numpy(dirs), tcfg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=1e-4)


def test_pack_matches_jax_pack(setup):
    """Same matrices as the JAX packing, minus its TPU-only padding (the
    128-lane output columns and the 2-D bias lift)."""
    jcfg, tcfg, jp, tp, _, _ = setup
    ref = jax.tree.map(np.asarray, jff.pack_field_weights(jp, jcfg))
    out = tff.pack_field_weights(tp, tcfg)
    assert sorted(out) == sorted(tff._WEIGHT_ORDER) == sorted(jff._WEIGHT_ORDER)
    n_out = 9 + 3 * tcfg.coarse_radiance_number
    for k in tff._WEIGHT_ORDER:
        r = ref[k]
        if k in ("A", "B", "C", "D"):
            r = r[:, :n_out]
        elif k == "bias":
            r = r[0, :n_out]
        elif r.ndim == 2 and r.shape[0] == 1:
            r = r[0]
        assert out[k].dtype == torch.float32 and out[k].is_contiguous()
        np.testing.assert_array_equal(out[k].numpy(), r, err_msg=k)


def test_cpu_wrappers_take_the_plain_version(setup):
    _, tcfg, _, tp, pts, dirs = setup
    packed = tff.pack_field_weights(tp, tcfg)
    before = dict(tff.LAUNCHES)
    p, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    assert torch.equal(tff.fused_field_apply(packed, p, d, tcfg),
                       tff.fused_field_apply_plain(packed, p, d, tcfg))
    assert torch.equal(tff.fused_field_density(packed, p, tcfg),
                       tff.fused_field_density_plain(packed, p, tcfg))
    assert tff.LAUNCHES == before  # the plain version is no launch


def test_kernel_input_checks():
    def packed_for(width):
        cfg = tfield.FieldConfig(depth=8, width=width, coarse_radiance_number=1)
        params = tfield.init_field_params(np.random.default_rng(0), cfg, "cpu")
        return cfg, params, tff.pack_field_weights(params, cfg)

    x = tff._pack_inputs(torch.rand(7, 19, 3), None)
    cfg, _, packed = packed_for(32)
    with pytest.raises(ValueError, match="width"):
        tff._check(packed, x, cfg)
    cfg, params, packed = packed_for(256)
    tff._check(packed, x, cfg)
    with pytest.raises(ValueError, match="f32"):
        tff._check(dict(packed, w1=packed["w1"].bfloat16()), x, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        tff._check(packed, x[:, :4], cfg)
    shifted = torch.zeros(packed["w1"].numel() + 1)[1:].view_as(packed["w1"])
    with pytest.raises(ValueError, match="aligned"):  # the kernel's 16-byte loads
        tff._check(dict(packed, w1=shifted), x, cfg)
    with pytest.raises(ValueError, match="coarse heads"):
        big = tfield.FieldConfig(depth=8, width=256, coarse_radiance_number=tff.MAX_COARSE + 1)
        tff._check(packed, x, big)
    with pytest.raises(ValueError):
        tff.fused_field_density(packed, torch.zeros(4, 3, device="meta"), cfg)
    with pytest.raises(ValueError, match="skip"):
        tff.pack_field_weights(params, tfield.FieldConfig(depth=8, width=256,
                                                          skips=(3,)))


def _heads_cfg(width, k):
    cfg = tfield.FieldConfig(depth=8, width=width, coarse_radiance_number=k)
    return cfg, tfield.init_field_params(np.random.default_rng(k + 7), cfg, "cpu")


def _outside(ranges, n_out):
    """Mask of the raw columns outside a projection's ranges."""
    mask = torch.ones(n_out, dtype=torch.bool)
    for lo, hi in ranges:
        mask[lo:hi] = False
    return mask


@pytest.mark.parametrize("k", [0, 1, 3])
def test_projection_columns_hold_every_nonzero_head_column(k):
    """The f32 kernel reads each projection only at `projection_columns`:
    the packer (and `_assembly_matrices`, freeze flags off) must leave A,
    B, C and each coarse head's rows of D zero everywhere else, and no
    column may be claimed by two projections of one layer output."""
    cfg, params = _heads_cfg(32, k)
    n_out, half = 9 + 3 * k, cfg.width // 2
    cols = tff.projection_columns(k)
    assert len(cols) == 3 + k
    packed = tff.pack_field_weights(params, cfg)
    A, B, C, D, _ = tfield._assembly_matrices(params, cfg, freeze_radiance=False,
                                              freeze_roughness=False)
    mats = {"A": (A, packed["A"]), "B": (B, packed["B"]), "C": (C, packed["C"])}
    for name, ranges in zip("ABC", cols):
        for m in mats[name]:
            assert m.shape[1] == n_out
            assert not m[:, _outside(ranges, n_out)].any(), name
            assert all(m[:, lo:hi].abs().amax(0).gt(0).all() for lo, hi in ranges), name
    for j in range(k):
        for m in (D, packed["D"]):
            rows = m[j * half:(j + 1) * half]
            assert not rows[:, _outside(cols[3 + j], n_out)].any(), j
    claimed = [c for ranges in cols[3:] for lo, hi in ranges for c in range(lo, hi)]
    assert len(claimed) == len(set(claimed)) == 3 * k
    assert all(0 <= lo <= hi <= n_out for ranges in cols for lo, hi in ranges)


def _trunk(packed, x):
    """The embedding and the 8-layer trunk's output h, as every variant of
    the f32 kernel computes them."""
    w, relu = packed, torch.relu
    t = x @ w["emb_E"]
    emb = torch.where(w["emb_id"] > 0.0, t, torch.sin(t + w["emb_phase"]))
    tb = w["tb"]
    h = relu(emb @ w["w0"] + tb[0])
    for i in (1, 2, 3, 4):
        h = relu(h @ w[f"w{i}"] + tb[i])
    h = relu(emb @ w["w5x"] + h @ w["w5h"] + tb[5])
    for i in (6, 7):
        h = relu(h @ w[f"w{i}"] + tb[i])
    return emb, h


def _kernel_order(packed, x, n_coarse):
    """The f32 kernel's dataflow in plain PyTorch: each head projected
    straight onto its raw columns from the layer that feeds it, h
    overwritten by `feature` and then by `h2`, the coarse heads in tiles
    of two, the bias added last."""
    w, relu = packed, torch.relu
    cols = tff.projection_columns(n_coarse)
    out = x.new_zeros((x.shape[0], 9 + 3 * n_coarse))

    def project(act, P, ranges):
        for lo, hi in ranges:
            out[:, lo:hi] += act @ P[:, lo:hi]

    emb, h = _trunk(packed, x)
    project(h, w["A"], cols[0])
    project(relu(h @ w["wpf"] + w["bpf"]), w["B"], cols[1])
    h = h @ w["wfeat"] + w["bfeat"]
    h = relu(h @ w["wv_f"] + emb @ w["wv_d"] + w["bv"])
    project(h, w["C"], cols[2])
    half = w["wfeat"].shape[0] // 2
    for k0 in range(0, n_coarse, 2):
        k1 = min(k0 + 2, n_coarse)
        tile = slice(k0 * half, k1 * half)
        vf = relu(h @ w["wcf"][:, tile] + w["bcf"][tile])
        for k in range(k0, k1):
            project(vf, w["D"][tile], cols[3 + k])
    return out + w["bias"]


@pytest.mark.parametrize("width,k", [(32, 0), (32, 1), (32, 2), (256, 3)])
def test_kernel_dataflow_matches_plain(width, k):
    cfg, params = _heads_cfg(width, k)
    packed = tff.pack_field_weights(params, cfg)
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (133, 1, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((133, 3)).astype(np.float32)), dim=-1)
    x = tff._pack_inputs(pts, dirs)
    ref = tff._field_plain(packed, x, density_only=False)
    out = _kernel_order(packed, x, k)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=0)
    sigma = tff._field_plain(packed, tff._pack_inputs(pts, None), density_only=True)
    np.testing.assert_allclose(out[:, :1].numpy(), sigma.numpy(), atol=1e-6, rtol=0)


# The density variant's lane tile (csrc/fused_field.cu: kDPts, kDCg): 16
# points x 8 columns a lane, so 8 column groups in a warp.
_D_COLUMN_GROUPS = 8


def _density_order(packed, x):
    """The f32 density variant's σ in plain PyTorch: the trunk as above,
    then h @ A[:, 0] summed as its lane tile does. Each of the 4 warps
    takes a quarter of the columns; in a warp, column c belongs to column
    group (c // 4) % 8 (runs of 4 columns, 32 apart), which sums its
    columns in order; the groups are added by an xor butterfly (group g
    with g ^ 1, then g ^ 2, then g ^ 4), the warps' shares in warp order,
    the bias last."""
    _, h = _trunk(packed, x)
    a = packed["A"][:, 0]
    per_warp = h.shape[1] // 4
    sigma = None
    for wq in range(4):
        groups = [h.new_zeros(h.shape[0]) for _ in range(_D_COLUMN_GROUPS)]
        for c in range(per_warp):
            col = wq * per_warp + c
            g = (c // 4) % _D_COLUMN_GROUPS
            groups[g] = groups[g] + h[:, col] * a[col]
        bit = 1
        while bit < _D_COLUMN_GROUPS:
            groups = [groups[g] + groups[g ^ bit] for g in range(_D_COLUMN_GROUPS)]
            bit *= 2
        sigma = groups[0] if sigma is None else sigma + groups[0]
    return (sigma + packed["bias"][0])[:, None]


@pytest.mark.parametrize("width", [32, 256])
@pytest.mark.parametrize("n", [133, 229])
def test_density_dataflow_matches_plain(width, n):
    """The density variant's σ order (133 and 229 points: neither a
    multiple of the 64-point tile) against the plain version."""
    cfg, params = _heads_cfg(width, 3)
    packed = tff.pack_field_weights(params, cfg)
    rng = np.random.default_rng(n)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (n, 1, 3)).astype(np.float32))
    x = tff._pack_inputs(pts, None)
    ref = tff._field_plain(packed, x, density_only=True)
    out = _density_order(packed, x)
    assert out.shape == ref.shape == (n, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=0)
