"""K2's slab stream, pure Python: the layout of the forward's weights,
layer after layer.

The CUDA kernel runs only on the card (chip_smoke.py holds it against
`train_forward_plain`); these tests check on the CPU that the stream
holds every weight once, transposed and zero-padded as the kernel reads
it, in as many slabs as the entry point checks, and that consuming the
stream slab after slab, as laid out, gives the plain forward. The order
in which `k2_forward` takes the slabs (C after hv, each vf pass with its
slab of D) and its 128-point tiles are modelled, with the residual
stores, in tests/test_torch_fused_field_bf16.py: K2 and K1 at bf16
weights run one kernel body (csrc/wgmma_field.cuh).
"""

import numpy as np
import pytest
import torch

from ibl_nerf_tpu_torch.kernels import fused_field as ff
from ibl_nerf_tpu_torch.kernels import fused_field_train as fft
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params

torch.set_num_threads(2)

TILE = 64  # points of a consumer warpgroup of k2_forward


def _shapes(k):
    """The packed weights' shapes at 8x256 with K coarse radiance lobes."""
    n_out, vf = 9 + 3 * k, 128 * k
    odd = {"w0": (128, 256), "w5x": (128, 256), "wv_d": (128, 256), "tb": (8, 256),
           "wcf": (256, vf), "A": (256, n_out), "B": (256, n_out), "C": (256, n_out),
           "D": (vf, n_out), "bcf": (vf,), "bias": (n_out,), "bpf": (256,), "bfeat": (256,),
           "bv": (256,)}
    return tuple((name, odd.get(name, (256, 256))) for name in fft._DW_ORDER)


def _random_w16(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
            for k, s in shapes}


def _slab_b(slab, n):
    """One slab (SLAB_N, SLAB_K) as the B block [columns][reduction rows]
    it holds: its rows are (k-block, column) pairs."""
    sn, sk = fft.slab_dims(n)
    return slab.reshape(sk // fft.SLAB_K, sn, fft.SLAB_K).transpose(0, 1).reshape(sn, sk)


def _unslab(slabs, shapes):
    """The inverse of `forward_slabs`: each summand's B = [n][k]."""
    sched, _ = fft.forward_schedule(shapes)
    out = {}
    for w, t, n, k, first, stride in sched:
        sn, sk = fft.slab_dims(n)
        passes, ks = -(-n // sn), -(-k // sk)
        b = torch.cat([torch.cat([_slab_b(slabs[first + p * stride + s], n) for s in range(ks)],
                                 dim=1) for p in range(passes)])
        out[w] = b[:n, :k]
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_forward_slabs_round_trip(k):
    shapes = _shapes(k)
    w16 = _random_w16(shapes)
    slabs = fft.forward_slabs(w16)
    sched, total = fft.forward_schedule(shapes)
    assert slabs.shape == (total, fft.SLAB_N, fft.SLAB_K)
    back = _unslab(slabs, shapes)
    for w, t, *_ in sched:
        assert t   # the forward reads every weight as w^T
        assert torch.equal(back[w], w16[w].t())
    # nothing but the weights: every other element is padding, zero
    assert int((slabs != 0).sum()) == int(sum((w16[w] != 0).sum() for w, *_ in sched))
    # the heads sit in narrow slabs: one per 256 reduction rows
    for w, t, n, kk, first, stride in sched:
        assert fft.slab_dims(n) == ((fft.NARROW_N, fft.NARROW_K) if w in ("A", "B", "C", "D")
                                    else (fft.SLAB_N, fft.SLAB_K))


@pytest.mark.parametrize("k", [1, 3])
def test_forward_schedule_tiles_the_stream(k):
    """Every slab of the stream belongs to exactly one (summand, pass,
    k-slab), in the kernel's layer order."""
    sched, total = fft.forward_schedule(_shapes(k))
    owner = np.full(total, -1)
    for i, (w, t, n, kk, first, stride) in enumerate(sched):
        sn, sk = fft.slab_dims(n)
        for p in range(-(-n // sn)):
            for s in range(-(-kk // sk)):
                assert owner[first + p * stride + s] == -1
                owner[first + p * stride + s] = i
    assert (owner >= 0).all()
    assert (np.diff(owner) >= 0).all()   # summand after summand, as the kernel reads them
    assert [w for w, *_ in sched] == [w for layer in fft._FORWARD_LAYERS for w, _ in layer]


@pytest.mark.parametrize("k", [1, 3])
def test_forward_slab_count_is_what_the_entry_point_checks(k):
    _, total = fft.forward_schedule(_shapes(k))
    vf = 128 * k

    def ks(c):
        return -(-c // fft.SLAB_K)

    def narrow(c):
        return -(-c // fft.NARROW_K)

    # forward_slab_count: h0, h1..h4, h5, h6, h7, pf; A, B; ft; hv; vf; C, D
    assert total == (ks(128) + 4 * ks(256) + ks(128) + ks(256) + 3 * ks(256)
                     + 2 * narrow(256) + ks(256) + ks(256) + ks(128)
                     + -(-vf // fft.SLAB_N) * ks(256) + narrow(256) + narrow(vf))
    if k == 3:
        assert total == 113


def _stream_forward(x, w16, emb, slabs):
    """K2's layers over the stream as laid out: per 64-point tile (rows
    past the end embed x = 0), the layers of `_FORWARD_LAYERS` in order, each pass of
    SLAB_N columns summing its operands' slabs in stream order in f32,
    then bias, relu and bf16 as the kernel's epilogues; the heads' f32
    sums into the raw tile. Returns raw and the residuals of the n rows."""
    bf = torch.bfloat16
    n, n_out = x.shape[0], w16["bias"].shape[0]
    raws, ress = [], []
    for base in range(0, n, TILE):
        xt = torch.zeros((TILE, x.shape[1]))
        xt[:min(TILE, n - base)] = x[base:base + TILE]
        ring = iter(slabs)

        def layer(ops, n_cols, bias, relu=True):
            acc = torch.zeros((TILE, -(-n_cols // fft.SLAB_N) * fft.SLAB_N))
            for c0 in range(0, n_cols, fft.SLAB_N):
                for a in ops:
                    for k0 in range(0, a.shape[1], fft.SLAB_K):
                        slab = next(ring).float()
                        acc[:, c0:c0 + fft.SLAB_N] += a[:, k0:k0 + fft.SLAB_K].float() @ slab.t()
            v = acc[:, :n_cols] + bias.float()
            return (torch.relu(v) if relu else v).to(bf)

        def head(ops):
            acc = torch.zeros((TILE, fft.NARROW_N))
            for a in ops:
                for k0 in range(0, a.shape[1], fft.NARROW_K):
                    b = _slab_b(next(ring), n_out).float()
                    part = a[:, k0:k0 + fft.NARROW_K].float()
                    acc += part @ b[:, :part.shape[1]].t()
            return acc[:, :n_out]

        tb = w16["tb"]
        xe = fft._embed(xt, emb).to(bf)
        hs = [layer([xe], 256, tb[0])]
        for i in range(1, 8):
            ops = [xe, hs[-1]] if i == 5 else [hs[-1]]
            hs.append(layer(ops, 256, tb[i]))
        pf = layer([hs[7]], 256, w16["bpf"])
        o = head([hs[7], pf])
        ft = layer([hs[7]], 256, w16["bfeat"], relu=False)
        hv = layer([ft, xe], 256, w16["bv"])
        vf = layer([hv], w16["wcf"].shape[1], w16["bcf"])
        o = o + head([hv, vf])
        assert next(ring, None) is None   # the tile used the whole stream
        keep = slice(0, min(TILE, n - base))
        raws.append((o + w16["bias"].float())[keep])
        ress.append(torch.stack(hs + [pf, ft, hv])[:, keep])
    return torch.cat(raws), torch.cat(ress, dim=1)


# bf16 activations after f32 sums taken in another order than the plain
# version's: an element near a rounding tie may land on the neighbouring
# bf16 value (2^-8 relative) and carry into later layers. Such flips stay
# far below 2e-3 of a block's norm; a wrong slab, order or offset gives O(1).
STREAM_REL = 2e-3


@pytest.mark.parametrize("n", [1, 63, 64, 130])
def test_executing_the_stream_gives_the_plain_forward(n):
    cfg = FieldConfig(depth=8, width=256, coarse_radiance_number=3)
    rng = np.random.default_rng(n)
    params = init_field_params(rng, cfg, "cpu")
    w16 = fft.to_bf16(ff.pack_field_weights(params, cfg))
    emb = fft.emb_constants(cfg, "cpu")
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (n, 1, 3)).astype(np.float32))
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    x = ff._pack_inputs(pts, dirs)

    raw, res = _stream_forward(x, w16, emb, fft.forward_slabs(w16))
    raw_p, res_p = fft.train_forward_plain(x, w16, emb)
    assert raw.shape == raw_p.shape and res.shape == res_p.shape
    blocks = {"raw": (raw, raw_p), **{k: (res[i], res_p[i])
                                      for i, k in enumerate(fft._RES_ORDER)}}
    for name, (got, want) in blocks.items():
        err = (got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)
        assert err <= STREAM_REL, f"{name}: {err:.3e}"
