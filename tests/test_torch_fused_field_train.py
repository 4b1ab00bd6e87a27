"""K2/K3's plain PyTorch versions and `FusedFieldTrain` against the JAX
Pallas training kernels.

The JAX side runs `_fwd_call` / `_bwd_call` and the custom_vjp
`fused_field_apply_train` in interpret mode, as tests/test_kernels.py
does. Both sides round at the same points (bf16 activations after an
f32 sum, f32 raw, bf16 deltas, f32 dW); they differ only in the order of
the f32 sums, so a hidden unit near a bf16 rounding tie can land on the
neighbouring value. The CUDA kernels themselves run only on the card,
where chip_smoke.py holds them against these plain versions.
"""

import contextlib
import ctypes

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.kernels import fused_field as jff
from ibl_nerf_tpu.kernels import fused_field_train as jfft
from ibl_nerf_tpu.models import field as jfield
from ibl_nerf_tpu.ops.embedding import positional_encoding as jpe
from ibl_nerf_tpu_torch.kernels import fused_field as tff
from ibl_nerf_tpu_torch.kernels import fused_field_train as tfft
from ibl_nerf_tpu_torch.models import field as tfield
from ibl_nerf_tpu_torch.ops.embedding import positional_encoding
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy

torch.set_num_threads(2)

N_OUT = 18


def _setup(width, n, seed=0):
    kw = dict(depth=8, width=width, coarse_radiance_number=3)
    jcfg, tcfg = jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)
    jp = jax.jit(jfield.init_field_params, static_argnums=1)(jax.random.key(seed), jcfg)
    tp = field_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed + 1)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g = (rng.standard_normal((n, N_OUT)) * 1e-2).astype(np.float32)
    return jcfg, tcfg, jp, tp, pts, dirs, g


def _jax_inputs(pts, dirs, n):
    """(x, g-shaped zeros) padded to the JAX kernels' tile multiple."""
    x = jff._pack_inputs(jnp.asarray(pts)[:, None, :], jnp.asarray(dirs))
    rows = -(-x.shape[0] // 512) * 512
    return jnp.pad(x, ((0, rows - x.shape[0]), (0, 0)))


def _torch_inputs(tp, tcfg, pts, dirs):
    w16 = tfft.to_bf16(tff.pack_field_weights(tp, tcfg))
    emb = tfft.emb_constants(tcfg, "cpu")
    x = tff._pack_inputs(torch.from_numpy(pts)[:, None, :], torch.from_numpy(dirs))
    return w16, emb, x


def _jax_dw(dws, k):
    """A JAX kernel dW block without its TPU padding (128-lane output
    columns, 2-D bias lift)."""
    v = np.asarray(dws[jfft._DW_ORDER.index(k)])
    if k in ("A", "B", "C", "D"):
        return v[:, :N_OUT]
    if k == "bias":
        return v[0, :N_OUT]
    return v[0] if v.ndim == 2 and v.shape[0] == 1 else v


# 600 points: a ragged count for the JAX tiles (512) and for K2/K3 (64)
@pytest.fixture(scope="module", params=[(32, 600), (256, 300)], ids=["w32", "w256"])
def kernels(request):
    width, n = request.param
    jcfg, tcfg, jp, tp, pts, dirs, g = _setup(width, n)
    w16j = jfft._to_bf16(jff.pack_field_weights(jp, jcfg))
    wlist = [w16j[k] for k in jff._WEIGHT_ORDER]
    xj = _jax_inputs(pts, dirs, n)
    outs = jfft._fwd_call(xj, wlist, interpret=True)
    gj = jnp.zeros((xj.shape[0], jff.LANE), jnp.float32).at[:n, :N_OUT].set(g)
    dws = jfft._bwd_call(xj, gj, list(outs[1:]), wlist, interpret=True)
    w16, emb, x = _torch_inputs(tp, tcfg, pts, dirs)
    return dict(n=n, outs=outs, dws=dws, w16=w16, emb=emb, x=x, g=g)


def test_forward_matches_jax_kernel(kernels):
    """raw and every residual bf16 plane within 2e-3 relative norm: at
    width 256 a few units flip by 2^-8 and carry that into the later
    layers (raw moves by up to 8e-4 of its scale); a wrong row, mask or
    bias moves a plane by O(1)."""
    k = kernels
    raw, res = tfft.train_forward_plain(k["x"], k["w16"], k["emb"])
    n = k["n"]
    assert raw.shape == (n, N_OUT) and raw.dtype == torch.float32
    assert res.shape[:2] == (11, n) and res.dtype == torch.bfloat16
    ref_raw = np.asarray(k["outs"][0])[:n, :N_OUT]
    assert np.linalg.norm(raw.numpy() - ref_raw) <= 2e-3 * np.linalg.norm(ref_raw)
    for i, name in enumerate(tfft._RES_ORDER):
        ref = np.asarray(k["outs"][1 + i], np.float32)[:n]
        out = res[i].float().numpy()
        assert np.linalg.norm(out - ref) <= 2e-3 * np.linalg.norm(ref), name


def test_backward_matches_jax_kernel(kernels):
    """On the JAX kernel's own residuals, every dW block within 2e-3
    relative norm. The reverse chain rounds each delta to bf16 after an
    f32 sum, so flips near ties travel down the chain (w0, the last,
    moves by 4e-4 at width 256); the reduction itself is f32."""
    k = kernels
    n = k["n"]
    res = torch.stack([torch.from_numpy(np.asarray(r, np.float32)[:n]).to(torch.bfloat16)
                       for r in k["outs"][1:]])
    dw = tfft.train_backward_plain(k["x"], torch.from_numpy(k["g"]), res, k["w16"], k["emb"])
    assert list(dw) == tfft._DW_ORDER
    for name in tfft._DW_ORDER:
        ref = _jax_dw(k["dws"], name)
        assert dw[name].shape == ref.shape and dw[name].dtype == torch.float32, name
        err = np.linalg.norm(dw[name].numpy() - ref)
        assert err <= 2e-3 * np.linalg.norm(ref) + 1e-12, (name, err)


def _grad_setup(width=32, n=160):
    jcfg, tcfg, jp, tp, pts, dirs, _ = _setup(width, n, seed=2)
    tgt = np.random.default_rng(5).standard_normal((n, N_OUT)).astype(np.float32)
    return jcfg, tcfg, jp, tp, pts, dirs, tgt


def _torch_grads(tp, fn):
    leaves = jax.tree.leaves(tp)  # the JAX flattening order
    for p in leaves:
        p.requires_grad_(True)
    grads = torch.autograd.grad(fn(tp), leaves)
    for p in leaves:
        p.requires_grad_(False)
    return torch.cat([g.reshape(-1) for g in grads]).numpy()


def test_fused_field_train_grads_match_jax_custom_vjp():
    """Grads into the field params through the f32 packing: the port's
    autograd Function against jax.grad of the JAX custom_vjp."""
    jcfg, tcfg, jp, tp, pts, dirs, tgt = _grad_setup()

    def jloss(p):
        packed = jff.pack_field_weights(p, jcfg, dtype=jnp.float32)
        raw = jfft.fused_field_apply_train(packed, jnp.asarray(pts)[:, None, :],
                                           jnp.asarray(dirs), jcfg, interpret=True)
        return jnp.mean((raw[:, 0] - tgt) ** 2)

    def tloss(p):
        raw = tfft.fused_field_apply_train(tff.pack_field_weights(p, tcfg),
                                           torch.from_numpy(pts)[:, None, :],
                                           torch.from_numpy(dirs), tcfg)
        return torch.mean((raw[:, 0] - torch.from_numpy(tgt)) ** 2)

    ref = np.asarray(jax.flatten_util.ravel_pytree(jax.grad(jloss)(jp))[0])
    out = _torch_grads(tp, tloss)
    assert np.linalg.norm(out - ref) <= 1e-5 * np.linalg.norm(ref)


def test_grads_at_least_as_accurate_as_eager_bf16():
    """tests/test_kernels.py's criterion on the port: the f32-accumulated
    dW of FusedFieldTrain is no farther from the f32 gradient than the
    eager bf16 autograd gradient is (x1.3 slack), and within 10%."""
    _, tcfg, _, tp, pts, dirs, tgt = _grad_setup(width=256, n=256)
    p, d, t = torch.from_numpy(pts)[:, None, :], torch.from_numpy(dirs), torch.from_numpy(tgt)

    def kern(q):
        raw = tfft.fused_field_apply_train(tff.pack_field_weights(q, tcfg), p, d, tcfg)
        return torch.mean((raw[:, 0] - t) ** 2)

    def eager(dt):
        def loss(q):
            qc = jax.tree.map(lambda v: v.to(dt), q)
            pe = positional_encoding(p, tcfg.multires).to(dt)
            de = positional_encoding(d, tcfg.multires_views).to(dt)[:, None, :]
            raw = tfield.apply_field(qc, pe, de, tcfg).float()
            return torch.mean((raw[:, 0] - t) ** 2)
        return loss

    gk = _torch_grads(tp, kern)
    gx = _torch_grads(tp, eager(torch.bfloat16))
    g32 = _torch_grads(tp, eager(torch.float32))
    err_k = np.linalg.norm(gk - g32) / np.linalg.norm(g32)
    err_x = np.linalg.norm(gx - g32) / np.linalg.norm(g32)
    assert np.isfinite(gk).all()
    assert err_k < 0.1, err_k
    assert err_k <= 1.3 * err_x, (err_k, err_x)


def test_zero_position_gradient():
    """Positions and directions get no gradient, as from the JAX kernel."""
    _, tcfg, _, tp, pts, dirs, _ = _grad_setup()
    p = torch.from_numpy(pts)[:, None, :].requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    packed = tff.pack_field_weights(tp, tcfg)
    raw = tfft.fused_field_apply_train(packed, p, d, tcfg)
    assert raw.shape == (len(pts), 1, N_OUT) and not raw.requires_grad
    for k in tfft._DW_ORDER:  # the embedding constants stay constants
        packed[k].requires_grad_(True)
    raw = tfft.fused_field_apply_train(packed, p, d, tcfg)
    raw.sum().backward()
    assert p.grad is None and d.grad is None
    assert packed["w1"].grad is not None and packed["emb_E"].grad is None


@pytest.mark.parametrize("residuals", [True, False], ids=["res", "nores"])
def test_cpu_wrappers_take_the_plain_version(residuals):
    _, tcfg, _, tp, pts, dirs, g = _setup(32, 70)
    w16, emb, x = _torch_inputs(tp, tcfg, pts, dirs)
    before = dict(tfft.LAUNCHES)
    raw, res = tfft.train_forward(x, w16, emb, residuals=residuals)
    raw_p, res_p = tfft.train_forward_plain(x, w16, emb)
    assert torch.equal(raw, raw_p)
    if residuals:
        assert torch.equal(res, res_p)
        g = torch.from_numpy(g)
        dw, dw_p = (tfft.train_backward(x, g, res, w16, emb),
                    tfft.train_backward_plain(x, g, res, w16, emb))
        assert all(torch.equal(dw[k], dw_p[k]) for k in tfft._DW_ORDER)
    else:   # the variant without residual stores computes none
        assert res is None and tfft.train_forward_plain(x, w16, emb, False)[1] is None
    assert tfft.LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError, match="device"):
        tfft.train_forward(x.to("meta"), w16, emb, residuals=residuals)


def _fake_device(monkeypatch, x, w16, emb):
    """Route the wrappers to `_launch_fwd` on CPU tensors, with an entry
    point that writes the plain version's raw and residuals where the
    kernel would; returns the residual pointers it was handed."""
    raw_p, res_p = tfft.train_forward_plain(x, w16, emb)
    handed = []

    def fwd(*args):
        raw_ptr, res_ptr = args[-3], args[-2]
        handed.append(res_ptr)
        ctypes.memmove(raw_ptr, raw_p.data_ptr(), raw_p.numel() * raw_p.element_size())
        if res_ptr is not None:
            ctypes.memmove(res_ptr, res_p.data_ptr(), res_p.numel() * res_p.element_size())
        return 0

    monkeypatch.setattr(tfft, "_device_of", lambda t: "cuda")
    monkeypatch.setattr(tfft, "_entries", lambda: (fwd, None))
    monkeypatch.setattr(tfft, "_stream", lambda d: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return handed


@pytest.mark.parametrize("mode", ["no_grad", "detached_weights", "grad"])
def test_forward_skips_the_residuals_where_no_backward_follows(mode, monkeypatch):
    """`fused_field_apply_train` launches K2 without residual stores (no
    planes allocated, the "fused_field_train_fwd_nores" count, outside
    autograd) under no_grad or when no packed weight requires grad, and
    with them through `FusedFieldTrain` otherwise; raw is the same."""
    _, tcfg, _, tp, pts, dirs, _ = _setup(256, 70)   # the kernel's width
    w16, emb, x = _torch_inputs(tp, tcfg, pts, dirs)
    packed = tff.pack_field_weights(tp, tcfg)
    if mode != "detached_weights":
        for k in tfft._DW_ORDER:
            packed[k].requires_grad_(True)
    p, d = torch.from_numpy(pts)[:, None, :], torch.from_numpy(dirs)
    want = tfft.train_forward_plain(x, w16, emb)[0]
    handed = _fake_device(monkeypatch, x, w16, emb)
    entered = []
    forward = tfft.FusedFieldTrain.forward
    monkeypatch.setattr(tfft.FusedFieldTrain, "forward",
                        staticmethod(lambda *a: entered.append(1) or forward(*a)))
    before = dict(tfft.LAUNCHES)
    with torch.set_grad_enabled(mode != "no_grad"):
        raw = tfft.fused_field_apply_train(packed, p, d, tcfg)
    counts = {k: v - before[k] for k, v in tfft.LAUNCHES.items()}
    assert torch.equal(raw.reshape(want.shape), want)
    if mode == "grad":
        assert raw.requires_grad and entered and handed[0] is not None
        assert counts == {"fused_field_train_fwd": 1, "fused_field_train_fwd_nores": 0,
                          "fused_field_train_bwd": 0}
    else:
        assert not raw.requires_grad and not entered and handed == [None]
        assert counts == {"fused_field_train_fwd": 0, "fused_field_train_fwd_nores": 1,
                          "fused_field_train_bwd": 0}


def test_no_grad_path_gives_the_grad_paths_raw_and_grads_unchanged():
    """On the plain versions: the wrapper's raw under no_grad equals its raw
    under grad bit for bit, and the gradients under grad are those of
    `FusedFieldTrain` called directly."""
    _, tcfg, _, tp, pts, dirs, tgt = _grad_setup()
    p, d, t = torch.from_numpy(pts)[:, None, :], torch.from_numpy(dirs), torch.from_numpy(tgt)
    packed = tff.pack_field_weights(tp, tcfg)
    with torch.no_grad():
        raw_ng = tfft.fused_field_apply_train(packed, p, d, tcfg)
    weights = [packed[k].detach().requires_grad_(True) for k in tfft._DW_ORDER]
    raw = tfft.fused_field_apply_train(dict(zip(tfft._DW_ORDER, weights)), p, d, tcfg)
    assert torch.equal(raw.detach(), raw_ng)
    grads = torch.autograd.grad(torch.mean((raw[:, 0] - t) ** 2), weights)
    x = tff._pack_inputs(p, d)
    direct = tfft.FusedFieldTrain.apply(tfft.emb_constants(tcfg, "cpu"), x, *weights)
    want = torch.autograd.grad(torch.mean((direct - t) ** 2), weights)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_dw_tables_cover_every_weight_once():
    """K3's reduction tables: each matrix is one act^T @ delta product,
    each bias one column sum (tb one per trunk layer), and they read only
    what the reverse chain and the residuals provide."""
    products = [k for k, _, _ in tfft._DW_PRODUCTS]
    sums = [k if row is None else (k, row) for k, row, _ in tfft._DW_SUMS]
    assert sorted(products + [k for k in sums if isinstance(k, str)] + ["tb"]) \
        == sorted(tfft._DW_ORDER)
    assert [s for s in sums if not isinstance(s, str)] == [("tb", i) for i in range(8)]
    available = set(tfft._RES_ORDER) | set(tfft._DELTA_ORDER) | {"g"}
    assert {a for _, a, _ in tfft._DW_PRODUCTS} <= available
    assert {dl for _, _, dl in tfft._DW_PRODUCTS + tfft._DW_SUMS} <= available


def test_kernel_input_checks():
    _, tcfg, _, tp, pts, dirs, _ = _setup(32, 10)
    w16, emb, x = _torch_inputs(tp, tcfg, pts, dirs)
    with pytest.raises(ValueError, match="width"):
        tfft._check(x, w16, emb, N_OUT)
    _, tcfg, _, tp, _, _, _ = _setup(256, 10)
    w16, emb, x = _torch_inputs(tp, tcfg, pts, dirs)
    tfft._check(x, w16, emb, N_OUT)
    with pytest.raises(ValueError, match="bf16"):
        tfft._check(x, dict(w16, w1=w16["w1"].float()), emb, N_OUT)
    with pytest.raises(ValueError, match="contiguous f32"):
        tfft._check(x[:, :4], w16, emb, N_OUT)
    with pytest.raises(ValueError, match="field config"):
        tfft._check(x, w16, emb, 15)
