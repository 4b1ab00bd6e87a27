"""K2 and K3: the fused training field query, forward and backward, as
CUDA kernels for Hopper.

Counterpart of ibl_nerf_tpu/kernels/fused_field_train.py (`_fwd_kernel`
and `_bwd_kernel`, the Pallas TPU kernels behind the custom_vjp
`fused_field_train`). The renderer routes the gradient-path full field
query of the coarse and fine passes through `fused_field_apply_train`
under `use_pallas_train` with bf16 gradients.

- K2 (`csrc/fused_field_train.cu`, `k2_forward`): per point the
  embedding, the 8-layer trunk and every head with bf16 operands and f32
  accumulation. It writes the raw output (N, 9+3K) in f32 and the 11
  bf16 residuals `h0..h7, pf, ft, hv` (`_RES_ORDER`) for the backward.
- K3 (`k3_delta_chain`, `k3_dw_gemm`, `k3_colsum`, `k3_reduce`, launched
  together by one entry point): recomputes the embedding and the coarse
  features `vf`, replays the reverse chain with relu masks read from the
  residuals, and reduces all 24 weight and bias gradients (`_DW_ORDER`)
  over the points in f32. dW is never rounded to bf16.

Gradient semantics, as in the JAX kernel: positions and directions get
no gradient. In training the sample positions are stop-gradient rooted
(rays are data, importance samples are detached), so `FusedFieldTrain`
returns None for its input; the renderer uses it only outside freeze
phases, and never for the sgs density gradient.

Beside the kernels live their plain PyTorch versions
(`train_forward_plain`, `train_backward_plain`), which round at the same
points: embedding in f32 then bf16; each layer f32 accumulate + bias,
relu, round to bf16; raw summed in f32 with the bf16 bias; relu masks
from the saved bf16 activations; g rounded to bf16 for the products
while the output bias sums the f32 g; every dW accumulated in f32. CPU
tensors take them; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ibl_nerf_tpu_torch.kernels import build as _build
from ibl_nerf_tpu_torch.kernels.fused_field import (
    IN_COLS,
    KERNEL_WIDTH,
    _pack_inputs,
    embedding_tensors,
)
from ibl_nerf_tpu_torch.models.field import FieldConfig

# Residual activations K2 saves for K3, in order.
_RES_ORDER = ["h0", "h1", "h2", "h3", "h4", "h5", "h6", "h7", "pf", "ft", "hv"]

# The 24 trainable packed weights, in order (shapes of pack_field_weights;
# the enum `DwIndex` in csrc/fused_field_train.cu lists the same names).
_DW_ORDER = ["w0", "w1", "w2", "w3", "w4", "w5x", "w5h", "w6", "w7",
             "tb", "wpf", "bpf", "wfeat", "bfeat", "wv_f", "wv_d", "bv",
             "wcf", "bcf", "A", "B", "C", "D", "bias"]
_MATRICES = [k for k in _DW_ORDER if k not in ("tb", "bpf", "bfeat", "bv", "bcf", "bias")]

# What K3's reverse chain writes for the weight-gradient reduction, in the
# order of the pointer list of `fused_field_train_bwd_launch`.
_DELTA_ORDER = ["x", "g16", "vf", "dvf", "dhv", "dft", "dpf",
                "d7", "d6", "d5", "d4", "d3", "d2", "d1", "d0"]

# dW = act^T @ delta over the points: (gradient, activation, delta).
_DW_PRODUCTS = [
    ("w0", "x", "d0"), ("w1", "h0", "d1"), ("w2", "h1", "d2"),
    ("w3", "h2", "d3"), ("w4", "h3", "d4"), ("w5x", "x", "d5"),
    ("w5h", "h4", "d5"), ("w6", "h5", "d6"), ("w7", "h6", "d7"),
    ("wpf", "h7", "dpf"), ("wfeat", "h7", "dft"), ("wv_f", "ft", "dhv"),
    ("wv_d", "x", "dhv"), ("wcf", "hv", "dvf"), ("A", "h7", "g16"),
    ("B", "pf", "g16"), ("C", "hv", "g16"), ("D", "vf", "g16")]
# bias gradients = column sums of a delta: (gradient, row of tb, delta).
_DW_SUMS = ([("tb", i, f"d{i}") for i in range(8)]
            + [("bpf", None, "dpf"), ("bfeat", None, "dft"), ("bv", None, "dhv"),
               ("bcf", None, "dvf"), ("bias", None, "g")])

# Launches of each kernel per wrapper; the plain versions never count.
LAUNCHES = {"fused_field_train_fwd": 0, "fused_field_train_bwd": 0}


def emb_constants(cfg: FieldConfig, device) -> dict[str, torch.Tensor]:
    """The f32 constants of the in-kernel positional encoding."""
    t = embedding_tensors(cfg, torch.device(device))
    return {"E": t["emb_E"], "phase": t["emb_phase"], "id": t["emb_id"]}


def to_bf16(weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The kernels' weights: the 24 packed f32 tensors rounded to bf16."""
    return {k: weights[k].detach().to(torch.bfloat16).contiguous() for k in _DW_ORDER}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _mmf(a, b):
    """bf16 operands, exact products, f32 sums."""
    return a.float() @ b.float()


def _embed(x, emb):
    t = x @ emb["E"]
    return torch.where(emb["id"] > 0.0, t, torch.sin(t + emb["phase"]))


def train_forward_plain(x: torch.Tensor, w16: dict, emb: dict):
    """K2's math: (N, 8) -> (raw (N, 9+3K) f32, residuals (11, N, W) bf16)."""
    bf = torch.bfloat16
    relu = torch.relu
    tb = w16["tb"].float()

    def layer(*pairs, bias, act=True):
        v = sum(_mmf(a, w16[k]) for a, k in pairs) + bias
        return (relu(v) if act else v).to(bf)

    xe = _embed(x, emb).to(bf)
    hs = [layer((xe, "w0"), bias=tb[0])]
    for i in (1, 2, 3, 4):
        hs.append(layer((hs[-1], f"w{i}"), bias=tb[i]))
    hs.append(layer((xe, "w5x"), (hs[-1], "w5h"), bias=tb[5]))
    for i in (6, 7):
        hs.append(layer((hs[-1], f"w{i}"), bias=tb[i]))
    h = hs[-1]
    pf = layer((h, "wpf"), bias=w16["bpf"].float())
    ft = layer((h, "wfeat"), bias=w16["bfeat"].float(), act=False)
    hv = layer((ft, "wv_f"), (xe, "wv_d"), bias=w16["bv"].float())
    vf = layer((hv, "wcf"), bias=w16["bcf"].float())
    raw = (_mmf(h, w16["A"]) + _mmf(pf, w16["B"]) + _mmf(hv, w16["C"])
           + _mmf(vf, w16["D"]) + w16["bias"].float())
    return raw, torch.stack(hs + [pf, ft, hv])


def delta_chain_plain(x, g, res, w16: dict, emb: dict) -> dict[str, torch.Tensor]:
    """The reverse chain of K3: the recomputed embedding and coarse
    features, bf16 g and every bf16 delta (`_DELTA_ORDER`)."""
    bf = torch.bfloat16

    def dot_bt(a, k):  # (T, n) x W(m, n)^T -> (T, m) f32
        return a.float() @ w16[k].float().t()

    def msk(val, d):   # relu backward, mask from the saved activation
        return torch.where(val.float() > 0.0, d, 0.0).to(bf)

    h = dict(zip(_RES_ORDER, res))
    d = {"x": _embed(x, emb).to(bf), "g16": g.to(bf)}
    g16 = d["g16"]
    d["vf"] = torch.relu(_mmf(h["hv"], w16["wcf"]) + w16["bcf"].float()).to(bf)
    d["dvf"] = msk(d["vf"], dot_bt(g16, "D"))
    d["dhv"] = msk(h["hv"], dot_bt(g16, "C") + dot_bt(d["dvf"], "wcf"))
    d["dft"] = dot_bt(d["dhv"], "wv_f").to(bf)       # ft has no relu
    d["dpf"] = msk(h["pf"], dot_bt(g16, "B"))
    d["d7"] = msk(h["h7"], dot_bt(g16, "A") + dot_bt(d["dft"], "wfeat")
                  + dot_bt(d["dpf"], "wpf"))
    d["d6"] = msk(h["h6"], dot_bt(d["d7"], "w7"))
    d["d5"] = msk(h["h5"], dot_bt(d["d6"], "w6"))
    d["d4"] = msk(h["h4"], dot_bt(d["d5"], "w5h"))
    for i in (4, 3, 2, 1):
        d[f"d{i - 1}"] = msk(h[f"h{i - 1}"], dot_bt(d[f"d{i}"], f"w{i}"))
    return d


def dw_from_deltas_plain(deltas: dict, res, g) -> dict[str, torch.Tensor]:
    """The weight-gradient reduction of K3: the `_DW_PRODUCTS` and
    `_DW_SUMS` tables over the points, in f32."""
    acts = dict(zip(_RES_ORDER, res), **deltas)
    dw = {k: acts[a].float().t() @ acts[dl].float() for k, a, dl in _DW_PRODUCTS}
    sums = {(k, row): (g if dl == "g" else acts[dl]).float().sum(0)
            for k, row, dl in _DW_SUMS}
    dw["tb"] = torch.stack([sums[("tb", i)] for i in range(8)])
    dw.update({k: v for (k, row), v in sums.items() if row is None})
    return {k: dw[k] for k in _DW_ORDER}


def train_backward_plain(x, g, res, w16: dict, emb: dict) -> dict[str, torch.Tensor]:
    """K3's math: the 24 f32 gradients of the packed weights."""
    return dw_from_deltas_plain(delta_chain_plain(x, g, res, w16, emb), res, g)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

@functools.cache
def _entries():
    """The two entry points of csrc/fused_field_train.cu, built on first use."""
    lib = _build.load("fused_field_train")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = lib.fused_field_train_fwd_launch
    fwd.restype = i
    fwd.argtypes = [p, ll, p, p, p, p, i, i, i, i, p, p, p]
    bwd = lib.fused_field_train_bwd_launch
    bwd.restype = i
    bwd.argtypes = [p, ll, p, p, p, p, p, p, i, p, i, i, i, p, i,
                    i, p, p, p, p, i, p, p, p, i, p, ll, p, p]
    return fwd, bwd


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check(x, w16, emb, n_out) -> None:
    if w16["w1"].shape != (KERNEL_WIDTH, KERNEL_WIDTH):
        raise ValueError(f"the CUDA kernels take width {KERNEL_WIDTH}, "
                         f"not {w16['w1'].shape[0]}")
    for k in _DW_ORDER:
        v = w16[k]
        if v.device != x.device or v.dtype != torch.bfloat16 or not v.is_contiguous():
            raise ValueError(f"weight {k} must be contiguous bf16 on {x.device}")
    for k, v in emb.items():
        if v.device != x.device or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"embedding constant {k} must be contiguous f32 "
                             f"on {x.device}")
    if w16["A"].shape[1] != n_out or w16["wcf"].shape[1] % 8:
        raise ValueError("packed weights do not match the field config")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != IN_COLS \
            or not x.is_contiguous():
        raise ValueError("kernel input must be contiguous f32 (N, 8)")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(x, w16, emb):
    n_out = w16["bias"].shape[0]
    _check(x, w16, emb, n_out)
    n, width, vf_cols = x.shape[0], KERNEL_WIDTH, w16["wcf"].shape[1]
    # K2 reads every matrix as [out][in]
    wt = [w16[k].t().contiguous() if k in _MATRICES else w16[k] for k in _DW_ORDER]
    raw = torch.empty((n, n_out), dtype=torch.float32, device=x.device)
    res = torch.empty((len(_RES_ORDER), n, width), dtype=torch.bfloat16,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = _entries()[0](
            x.data_ptr(), n, emb["E"].data_ptr(), emb["phase"].data_ptr(),
            emb["id"].data_ptr(), ctypes.cast(_ptr_array(wt), ctypes.c_void_p),
            len(wt), width, n_out, vf_cols, raw.data_ptr(), res.data_ptr(),
            _stream(x.device))
    if err != 0:
        raise RuntimeError(f"fused_field_train forward kernel launch failed: error {err}")
    LAUNCHES["fused_field_train_fwd"] += 1
    return raw, res


def dw_splits(n: int) -> int:
    """Point ranges the weight-gradient reduction is split into: one per
    4096 points, at most 32. Each range writes its own f32 partial and a
    second pass sums them in a fixed order, so the result does not
    depend on scheduling."""
    return max(1, min(32, -(-n // 4096)))


def _launch_bwd(x, g, res, w16, emb):
    n_out = g.shape[1]
    _check(x, w16, emb, n_out)
    if g.dtype != torch.float32 or g.shape[0] != x.shape[0] or not g.is_contiguous():
        raise ValueError("the output cotangent must be contiguous f32 (N, 9+3K)")
    n, width, vf_cols = x.shape[0], KERNEL_WIDTH, w16["wcf"].shape[1]
    if res.shape != (len(_RES_ORDER), n, width) or res.dtype != torch.bfloat16 \
            or not res.is_contiguous():
        raise ValueError("residuals must be contiguous bf16 (11, N, 256)")
    dev = x.device
    cols = {"x": w16["w0"].shape[0], "g16": n_out, "vf": vf_cols, "dvf": vf_cols}
    deltas = {k: torch.empty((n, cols.get(k, width)), dtype=torch.bfloat16, device=dev)
              for k in _DELTA_ORDER}
    acts = dict(zip(_RES_ORDER, res), **deltas, g=g)

    # flat f32 gradient buffer, one view per packed weight
    sizes = [w16[k].numel() for k in _DW_ORDER]
    offs = dict(zip(_DW_ORDER, [sum(sizes[:i]) for i in range(len(sizes))]))
    total = sum(sizes)
    dw_flat = torch.empty(total, dtype=torch.float32, device=dev)
    splits = dw_splits(n)
    partial = torch.empty((splits, total), dtype=torch.float32, device=dev)

    g_act = [acts[a] for _, a, _ in _DW_PRODUCTS]
    g_del = [acts[dl] for _, _, dl in _DW_PRODUCTS]
    g_dims = (ctypes.c_int * (4 * len(_DW_PRODUCTS)))(*[
        v for (k, a, dl) in _DW_PRODUCTS
        for v in (acts[a].shape[1], acts[dl].shape[1], *w16[k].shape)])
    g_off = (ctypes.c_longlong * len(_DW_PRODUCTS))(*[offs[k] for k, _, _ in _DW_PRODUCTS])
    s_del = [acts[dl] for _, _, dl in _DW_SUMS]
    s_dims = (ctypes.c_int * (3 * len(_DW_SUMS)))(*[
        v for (_, _, dl) in _DW_SUMS
        for v in (acts[dl].shape[1], acts[dl].shape[1], int(dl == "g"))])
    s_off = (ctypes.c_longlong * len(_DW_SUMS))(*[
        offs[k] + (row * width if row is not None else 0) for k, row, _ in _DW_SUMS])

    wcf_t = w16["wcf"].t().contiguous()
    with torch.cuda.device(dev):
        err = _entries()[1](
            x.data_ptr(), n, g.data_ptr(), res.data_ptr(), emb["E"].data_ptr(),
            emb["phase"].data_ptr(), emb["id"].data_ptr(),
            ctypes.cast(_ptr_array([w16[k] for k in _DW_ORDER]), ctypes.c_void_p),
            len(_DW_ORDER), wcf_t.data_ptr(), width, n_out, vf_cols,
            ctypes.cast(_ptr_array([deltas[k] for k in _DELTA_ORDER]), ctypes.c_void_p),
            len(_DELTA_ORDER),
            len(_DW_PRODUCTS), ctypes.cast(_ptr_array(g_act), ctypes.c_void_p),
            ctypes.cast(_ptr_array(g_del), ctypes.c_void_p),
            ctypes.cast(g_dims, ctypes.c_void_p), ctypes.cast(g_off, ctypes.c_void_p),
            len(_DW_SUMS), ctypes.cast(_ptr_array(s_del), ctypes.c_void_p),
            ctypes.cast(s_dims, ctypes.c_void_p), ctypes.cast(s_off, ctypes.c_void_p),
            splits, partial.data_ptr(), total, dw_flat.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_field_train backward kernel launch failed: error {err}")
    LAUNCHES["fused_field_train_bwd"] += 1
    return {k: dw_flat[offs[k]:offs[k] + w16[k].numel()].view(w16[k].shape)
            for k in _DW_ORDER}


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused train field for device {x.device}")
    return x.device.type


def train_forward(x, w16, emb):
    """K2 on CUDA tensors, its plain version on CPU ones."""
    if _device_of(x) == "cuda":
        return _launch_fwd(x, w16, emb)
    return train_forward_plain(x, w16, emb)


def train_backward(x, g, res, w16, emb):
    """K3 on CUDA tensors, its plain version on CPU ones."""
    if _device_of(x) == "cuda":
        return _launch_bwd(x, g, res, w16, emb)
    return train_backward_plain(x, g, res, w16, emb)


class FusedFieldTrain(torch.autograd.Function):
    """The full field query with K2 forward and K3 backward.

    forward(emb, x, *weights): emb is `emb_constants`, x the (N, 8)
    packed input, weights the 24 packed f32 tensors in `_DW_ORDER`
    (gradients flow from them back through the packing to the field
    params). Returns raw (N, 9+3K) f32. backward returns f32 gradients for
    the 24 tensors and None for x: the zero position cotangent of the JAX
    kernel.
    """

    @staticmethod
    def forward(ctx, emb, x, *weights):
        w16 = to_bf16(dict(zip(_DW_ORDER, weights)))
        raw, res = train_forward(x, w16, emb)
        ctx.save_for_backward(x, res)
        ctx.w16, ctx.emb = w16, emb
        return raw

    @staticmethod
    def backward(ctx, g):
        x, res = ctx.saved_tensors
        dw = train_backward(x, g.float().contiguous(), res, ctx.w16, ctx.emb)
        return (None, None, *[dw[k] for k in _DW_ORDER])


def fused_field_apply_train(packed32: dict, pts: torch.Tensor, dirs: torch.Tensor,
                            cfg: FieldConfig) -> torch.Tensor:
    """apply_field-shaped wrapper: pts (..., S, 3), dirs (..., 3) -> raw
    (..., S, 9+3K) f32, differentiable with respect to `packed32`
    (`pack_field_weights` of the field params, not detached)."""
    x = _pack_inputs(pts.detach(), dirs.detach())
    emb = emb_constants(cfg, x.device)
    out = FusedFieldTrain.apply(emb, x, *[packed32[k] for k in _DW_ORDER])
    return out.reshape(*pts.shape[:-1], out.shape[-1])
