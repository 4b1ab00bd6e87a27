"""K2 and K3: the fused training field query, forward and backward, as
CUDA kernels for Hopper.

Counterpart of ibl_nerf_tpu/kernels/fused_field_train.py (`_fwd_kernel`
and `_bwd_kernel`, the Pallas TPU kernels behind the custom_vjp
`fused_field_train`). The renderer routes the gradient-path full field
query of the coarse and fine passes through `fused_field_apply_train`
under `use_pallas_train` with bf16 gradients.

- K2 (`csrc/fused_field_train.cu`: `k2_pack_slabs`, `k2_forward`,
  launched together by one entry point; its body is the wgmma field chain
  of `csrc/wgmma_field.cuh`, which K1 at bf16 weights runs too): per point
  the embedding, the 8-layer trunk and every head with bf16 operands and
  f32 accumulation, its weights streamed as slabs (`forward_schedule`,
  `forward_slabs`). It writes the raw output (N, 9+3K) in f32 and the 11
  bf16 residuals `h0..h7, pf, ft, hv` (`_RES_ORDER`) for the backward; a
  call that no backward follows (`fused_field_apply_train` with grad off,
  or no packed weight that requires grad) launches its variant without
  residual stores, which allocates no planes and gives the same raw bit
  for bit.
- K3 (`k3_pack_slabs`, `k3_delta_chain`, `k3_dw_gemm`, `k3_reduce`,
  launched together by one entry point): recomputes the embedding and the
  coarse features `vf`, replays the reverse chain with relu masks read
  from the residuals, its weights streamed as slabs (`chain_schedule`,
  `chain_slabs`), and reduces all 24 weight and bias gradients
  (`_DW_ORDER`) over point ranges in f32 by the jobs of `k3_plan`. dW is
  never rounded to bf16.

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
tensors take them; CUDA tensors launch the kernels or raise. The host
wrappers of the launches are the spans `kernel.k2` and `kernel.k3`
(`utils/timing`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math

import torch

from ibl_nerf_tpu_torch.kernels import build as _build
from ibl_nerf_tpu_torch.kernels.fused_field import (
    IN_COLS,
    KERNEL_WIDTH,
    _pack_inputs,
    embedding_tensors,
)
from ibl_nerf_tpu_torch.models.field import FieldConfig
from ibl_nerf_tpu_torch.utils.timing import span

# Residual activations K2 saves for K3, in order.
_RES_ORDER = ["h0", "h1", "h2", "h3", "h4", "h5", "h6", "h7", "pf", "ft", "hv"]

# The 24 trainable packed weights, in order (shapes of pack_field_weights;
# the enum `DwIndex` in csrc/fused_field_train.cu lists the same names).
_DW_ORDER = ["w0", "w1", "w2", "w3", "w4", "w5x", "w5h", "w6", "w7",
             "tb", "wpf", "bpf", "wfeat", "bfeat", "wv_f", "wv_d", "bv",
             "wcf", "bcf", "A", "B", "C", "D", "bias"]

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
# "fused_field_train_fwd_nores": K2 without its residual stores.
LAUNCHES = {"fused_field_train_fwd": 0, "fused_field_train_fwd_nores": 0,
            "fused_field_train_bwd": 0}


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


def _layer(w16: dict, *pairs, bias, act=True):
    """sum of a @ w16[k] over the pairs, in f32, + bias; relu; bf16."""
    v = sum(_mmf(a, w16[k]) for a, k in pairs) + bias
    return (torch.relu(v) if act else v).to(torch.bfloat16)


def _trunk_plain(xe: torch.Tensor, w16: dict) -> list[torch.Tensor]:
    """h0..h7 from the bf16 embedding (layer 5 reads it again)."""
    tb = w16["tb"].float()
    hs = [_layer(w16, (xe, "w0"), bias=tb[0])]
    for i in (1, 2, 3, 4):
        hs.append(_layer(w16, (hs[-1], f"w{i}"), bias=tb[i]))
    hs.append(_layer(w16, (xe, "w5x"), (hs[-1], "w5h"), bias=tb[5]))
    for i in (6, 7):
        hs.append(_layer(w16, (hs[-1], f"w{i}"), bias=tb[i]))
    return hs


def train_forward_plain(x: torch.Tensor, w16: dict, emb: dict, residuals: bool = True):
    """K2's math: (N, 8) -> (raw (N, 9+3K) f32, residuals (11, N, W) bf16);
    with `residuals` False the residuals are None (K2's variant without
    residual stores)."""
    xe = _embed(x, emb).to(torch.bfloat16)
    hs = _trunk_plain(xe, w16)
    h = hs[-1]
    pf = _layer(w16, (h, "wpf"), bias=w16["bpf"].float())
    ft = _layer(w16, (h, "wfeat"), bias=w16["bfeat"].float(), act=False)
    hv = _layer(w16, (ft, "wv_f"), (xe, "wv_d"), bias=w16["bv"].float())
    vf = _layer(w16, (hv, "wcf"), bias=w16["bcf"].float())
    raw = (_mmf(h, w16["A"]) + _mmf(pf, w16["B"]) + _mmf(hv, w16["C"])
           + _mmf(vf, w16["D"]) + w16["bias"].float())
    return raw, (torch.stack(hs + [pf, ft, hv]) if residuals else None)


def field_bf16_plain(x: torch.Tensor, w16: dict, emb: dict,
                     density_only: bool) -> torch.Tensor:
    """K1's bf16-weight variant (plain version of csrc/fused_field_bf16.cu):
    the JAX `_field_kernel` with bf16 packed weights rounds where K2 does,
    so the full variant is K2's raw (N, 9+3K) and the density variant the
    same trunk, then sigma = h7 @ A[:, :1] + bias[:1] in f32, (N, 1)."""
    if not density_only:
        return train_forward_plain(x, w16, emb, residuals=False)[0]
    h = _trunk_plain(_embed(x, emb).to(torch.bfloat16), w16)[-1]
    return _mmf(h, w16["A"][:, :1]) + w16["bias"][:1].float()


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
# K3's launch plan (pure Python; the CUDA entry point takes it as tables)
# ---------------------------------------------------------------------------

DW_TILE = 128    # output tile edge of a wide dW job
DW_NARROW = 32   # columns of a narrow job (the output heads, 9+3K <= 32)
DW_POINTS = 32   # points per pipeline stage of the dW GEMM
SLAB_N, SLAB_K = 256, 32   # a chain weight slab: output columns (a pass) x reduction rows
NARROW_N = 32              # a narrow slab's output columns (K2's heads, 9+3K <= 32)
NARROW_K = SLAB_N * SLAB_K // NARROW_N

# The planes the dW GEMM reads, by index: the residuals, then the deltas.
_PLANES = _RES_ORDER + _DELTA_ORDER


def dw_splits(n: int) -> int:
    """Point ranges the weight-gradient reduction is split into: one per
    4096 points, at most 32. Each range writes its own f32 partial and a
    second pass sums them in a fixed order, so the result does not
    depend on scheduling."""
    return max(1, min(32, -(-n // 4096)))


def plane_cols(shapes: dict) -> dict[str, int]:
    """Columns of each plane of `_PLANES` for packed weights of these
    shapes. g16 is written DW_NARROW wide (zero past 9+3K), so that every
    row of every plane is a whole number of 16-byte chunks."""
    width, vf_cols = shapes["w1"][0], shapes["wcf"][1]
    cols = {k: width for k in _PLANES}
    cols.update(x=shapes["w0"][0], g16=DW_NARROW, vf=vf_cols, dvf=vf_cols)
    return cols


@dataclasses.dataclass(frozen=True)
class DwJob:
    """One output tile of one weight gradient, reduced over one point
    range: gradient[m0:m0 + DW_TILE, n0:n0 + tile columns] (clipped to
    its shape (m, n)) = act^T @ delta. `out` is the gradient's offset in
    the flat f32 gradient. With `sum_src` 1 the tile also takes the
    column sums of its delta tile, with 2 those of the f32 cotangent g,
    into the flat gradient from `sum_out` (the bias gradient of those
    columns); with 0 it takes none."""
    weight: str
    act: str
    delta: str
    m0: int
    n0: int
    m: int
    n: int
    out: int
    sum_out: int = 0
    sum_src: int = 0

    @property
    def cols(self) -> int:
        """The tile's columns (DW_TILE wide, DW_NARROW narrow)."""
        return DW_TILE if self.n > DW_NARROW else DW_NARROW


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """The dW stage of K3 for n points: blocks (job, range) for every job
    and every range; each range writes its own partial of `total` f32."""
    chunk: int
    ranges: tuple[tuple[int, int], ...]
    jobs: tuple[DwJob, ...]
    offsets: tuple[tuple[str, int], ...]   # of each gradient in the flat one
    total: int
    shapes: tuple   # (name, shape) of the packed weights, in _DW_ORDER

    @functools.cached_property
    def table(self) -> ctypes.Array:
        """The jobs as the entry point takes them: DwJob's 11 ints each."""
        cols = plane_cols(dict(self.shapes))
        return (ctypes.c_int * (11 * len(self.jobs)))(*[
            v for j in self.jobs for v in (
                _PLANES.index(j.act), _PLANES.index(j.delta), cols[j.act], cols[j.delta],
                j.m0, j.n0, j.m, j.n, j.out, j.sum_out, j.sum_src)])


@functools.lru_cache(maxsize=64)
def k3_plan(n: int, shapes: tuple) -> K3Plan:
    """K3's dW stage for n points and packed weights of `shapes` ((name,
    shape) pairs in `_DW_ORDER`): the point ranges (`dw_splits`, each a
    whole number of DW_POINTS stages but the last), the tile jobs of every
    `_DW_PRODUCTS` entry, and where each writes its dW and bias sums.
    Each bias sum of `_DW_SUMS` rides on the m0 = 0 tiles of the first
    product that reads its delta (the output bias, a sum of the f32 g, on
    the first product of g16). A function of n and the shapes alone."""
    shape = dict(shapes)
    sizes = [math.prod(shape[k]) for k in _DW_ORDER]
    offs = dict(zip(_DW_ORDER, itertools.accumulate([0] + sizes)))
    splits = dw_splits(n)
    chunk = -(-(-(-n // splits)) // DW_POINTS) * DW_POINTS
    ranges = tuple((min(n, r * chunk), min(n, (r + 1) * chunk)) for r in range(splits))
    width = shape["tb"][1]
    bias_out = {("g16" if dl == "g" else dl): offs[k] + (row * width if row is not None else 0)
                for k, row, dl in _DW_SUMS}
    jobs = []
    for k, a, dl in _DW_PRODUCTS:
        m, cols = shape[k]
        takes = dl in bias_out
        src = 2 if dl == "g16" else 1
        tile_n = DW_TILE if cols > DW_NARROW else DW_NARROW
        for m0 in range(0, m, DW_TILE):
            for n0 in range(0, cols, tile_n):
                s = takes and m0 == 0
                jobs.append(DwJob(k, a, dl, m0, n0, m, cols, offs[k],
                                  bias_out[dl] + n0 if s else 0, src if s else 0))
        bias_out.pop(dl, None)
    if bias_out:
        raise ValueError(f"no product reads the deltas of the bias sums {sorted(bias_out)}")
    return K3Plan(chunk, ranges, tuple(jobs), tuple(offs.items()), sum(sizes), shapes)


# K3's reverse chain, layer by layer in the kernel's order: the weight of
# each summand, read as B = [n][k] (transposed for the recomputed vf).
_CHAIN_LAYERS = [[("wcf", True)], [("D", False)], [("C", False), ("wcf", False)],
                 [("wv_f", False)], [("B", False)],
                 [("A", False), ("wfeat", False), ("wpf", False)],
                 *[[(w, False)] for w in ("w7", "w6", "w5h", "w4", "w3", "w2", "w1")]]

# K2's forward, layer by layer in the kernel's order, every weight read as
# B = w^T: the trunk (layer 5: the embedding before h4), pf, the heads A
# and B, ft, hv (ft before the embedding), vf, the heads C and D.
_FORWARD_LAYERS = [[(w, True)] for w in ("w0", "w1", "w2", "w3", "w4")] + [
    [("w5x", True), ("w5h", True)], [("w6", True)], [("w7", True)], [("wpf", True)],
    [("A", True), ("B", True)], [("wfeat", True)], [("wv_f", True), ("wv_d", True)],
    [("wcf", True)], [("C", True), ("D", True)]]
# K1's bf16 density variant (csrc/fused_field_bf16.cu): the trunk (h0..h7),
# then sigma's head A.
_DENSITY_LAYERS = _FORWARD_LAYERS[:8] + [[("A", True)]]


def slab_dims(n: int) -> tuple[int, int]:
    """(output columns, reduction rows) of one slab of a B with n columns:
    SLAB_N x SLAB_K, or for at most NARROW_N columns (K2's output heads) a
    narrow slab of NARROW_N x NARROW_K, kept as NARROW_K / SLAB_K blocks of
    [NARROW_N][SLAB_K]. Either is SLAB_N * SLAB_K elements."""
    return (NARROW_N, NARROW_K) if n <= NARROW_N else (SLAB_N, SLAB_K)


def _schedule(layers, shapes: tuple) -> tuple[tuple[tuple, ...], int]:
    shape = dict(shapes)
    ops, first = [], 0
    for layer in layers:
        dims = [(shape[w][::-1] if t else shape[w]) for w, t in layer]
        sn, sk = slab_dims(dims[0][0])
        stride = sum(-(-k // sk) for _, k in dims)
        at = first
        for (w, t), (n, k) in zip(layer, dims):
            ops.append((w, t, n, k, at, stride))
            at += -(-k // sk)
        first += -(-dims[0][0] // sn) * stride
    return tuple(ops), first


@functools.lru_cache(maxsize=8)
def chain_schedule(shapes: tuple) -> tuple[tuple[tuple, ...], int]:
    """Where each chain weight's slabs lie in the slab stream: per summand
    (weight, transposed, n, k, first, stride) -- its B's shape, the slab
    index of pass 0's first k-slab, and the slabs of one pass of its layer
    (a layer's passes of SLAB_N columns in order, within a pass each
    summand's k-slabs in order) -- and the number of slabs."""
    return _schedule(_CHAIN_LAYERS, shapes)


@functools.lru_cache(maxsize=8)
def forward_schedule(shapes: tuple) -> tuple[tuple[tuple, ...], int]:
    """K2's slab stream, as `chain_schedule` lays out K3's: every weight
    of `_FORWARD_LAYERS` as B = w^T, the heads in narrow slabs
    (`slab_dims`)."""
    return _schedule(_FORWARD_LAYERS, shapes)


@functools.lru_cache(maxsize=8)
def density_schedule(shapes: tuple) -> tuple[tuple[tuple, ...], int]:
    """The slab stream of K1's bf16 density variant: the trunk's layers of
    `_FORWARD_LAYERS`, then the head A alone in a narrow slab."""
    return _schedule(_DENSITY_LAYERS, shapes)


def _slabs(schedule, w16: dict) -> torch.Tensor:
    sched, total = schedule(_shapes(w16))
    out = w16["w1"].new_zeros((total, SLAB_N * SLAB_K))
    for w, t, n, k, first, stride in sched:
        b = w16[w].t() if t else w16[w]
        sn, sk = slab_dims(n)
        for p in range(-(-n // sn)):
            for s in range(-(-k // sk)):
                blk = b.new_zeros((sn, sk))
                part = b[p * sn:(p + 1) * sn, s * sk:(s + 1) * sk]
                blk[:part.shape[0], :part.shape[1]] = part
                # rows (k-block, column), SLAB_K reduction rows each
                out[first + p * stride + s] = blk.reshape(sn, sk // SLAB_K, SLAB_K) \
                    .transpose(0, 1).reshape(-1)
    return out.view(total, SLAB_N, SLAB_K)


def chain_slabs(w16: dict) -> torch.Tensor:
    """The slab stream of the chain's weights (plain version of
    k3_pack_slabs): (slabs, SLAB_N, SLAB_K), zero past each B's edges."""
    return _slabs(chain_schedule, w16)


def forward_slabs(w16: dict) -> torch.Tensor:
    """The slab stream of the forward's weights (plain version of
    k2_pack_slabs), as `chain_slabs`."""
    return _slabs(forward_schedule, w16)


def density_slabs(w16: dict) -> torch.Tensor:
    """The slab stream of K1's bf16 density variant (plain version of
    k1_bf16_pack_slabs in csrc/fused_field_bf16.cu with `density_schedule`),
    as `chain_slabs`."""
    return _slabs(density_schedule, w16)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

@functools.cache
def _entries():
    """The entry points of csrc/fused_field_train.cu, built on first use:
    K2 and K3."""
    lib = _build.load("fused_field_train")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = lib.fused_field_train_fwd_launch
    fwd.restype = i
    fwd.argtypes = [p, ll, p, p, p, p, i, i, i, i, p, i, p, i, p, p, p]
    bwd = lib.fused_field_train_bwd_launch
    bwd.restype = i
    bwd.argtypes = [p, ll, p, p, p, p, p, p, i, i, i, i, p, i, p, i,
                    p, i, p, i, p, i, ll, i, p, ll, p, p]
    return fwd, bwd


def _shapes(w16: dict) -> tuple:
    return tuple((k, tuple(w16[k].shape)) for k in _DW_ORDER)


def _ptrs(values) -> ctypes.c_void_p:
    return ctypes.cast((ctypes.c_void_p * len(values))(*values), ctypes.c_void_p)


@functools.lru_cache(maxsize=16)
def _slab_table(sched: tuple) -> ctypes.Array:
    """A schedule as the pack kernels take it: 6 ints per summand (weight
    index in `_DW_ORDER`, trans, n, k, first, stride)."""
    return (ctypes.c_int * (6 * len(sched)))(*[
        v for w, t, n, k, first, stride in sched
        for v in (_DW_ORDER.index(w), int(t), n, k, first, stride)])


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


def _launch_fwd(x, w16, emb, residuals: bool = True):
    """K2 on CUDA tensors: (raw, the residual planes), or with `residuals`
    False (raw, None) from the variant that stores and allocates none."""
    n_out = w16["bias"].shape[0]
    _check(x, w16, emb, n_out)
    n, width, vf_cols = x.shape[0], KERNEL_WIDTH, w16["wcf"].shape[1]
    sched, n_slabs = forward_schedule(_shapes(w16))
    raw = torch.empty((n, n_out), dtype=torch.float32, device=x.device)
    res = torch.empty((len(_RES_ORDER), n, width), dtype=torch.bfloat16,
                      device=x.device) if residuals else None
    slabs = torch.empty(n_slabs * SLAB_N * SLAB_K, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = _entries()[0](
            x.data_ptr(), n, emb["E"].data_ptr(), emb["phase"].data_ptr(),
            emb["id"].data_ptr(), _ptrs([w16[k].data_ptr() for k in _DW_ORDER]),
            len(_DW_ORDER), width, n_out, vf_cols,
            ctypes.cast(_slab_table(sched), ctypes.c_void_p), len(sched),
            slabs.data_ptr(), n_slabs, raw.data_ptr(),
            res.data_ptr() if residuals else None, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"fused_field_train forward kernel launch failed: error {err}")
    LAUNCHES["fused_field_train_fwd" if residuals else "fused_field_train_fwd_nores"] += 1
    return raw, res


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
    shapes = _shapes(w16)
    plan = k3_plan(n, shapes)
    sched, n_slabs = chain_schedule(shapes)
    cols = plane_cols(dict(shapes))

    # every delta plane in one buffer (each a whole number of 16-byte rows)
    sizes = [n * cols[k] for k in _DELTA_ORDER]
    scratch = torch.empty(sum(sizes) + n_slabs * SLAB_N * SLAB_K, dtype=torch.bfloat16,
                          device=dev)
    starts = [scratch.data_ptr() + 2 * s for s in itertools.accumulate([0] + sizes)]
    deltas, slabs = starts[:-1], starts[-1]
    planes = [res.data_ptr() + 2 * i * n * width for i in range(len(_RES_ORDER))] + deltas
    partial = torch.empty((len(plan.ranges), plan.total), dtype=torch.float32, device=dev)
    dw_flat = torch.empty(plan.total, dtype=torch.float32, device=dev)

    with torch.cuda.device(dev):
        err = _entries()[1](
            x.data_ptr(), n, g.data_ptr(), res.data_ptr(), emb["E"].data_ptr(),
            emb["phase"].data_ptr(), emb["id"].data_ptr(),
            _ptrs([w16[k].data_ptr() for k in _DW_ORDER]), len(_DW_ORDER), width, n_out,
            vf_cols, ctypes.cast(_slab_table(sched), ctypes.c_void_p), len(sched), slabs,
            n_slabs, _ptrs(deltas), len(deltas), _ptrs(planes), len(planes),
            ctypes.cast(plan.table, ctypes.c_void_p), len(plan.jobs), plan.chunk,
            len(plan.ranges), partial.data_ptr(), plan.total, dw_flat.data_ptr(),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_field_train backward kernel launch failed: error {err}")
    LAUNCHES["fused_field_train_bwd"] += 1
    offs = dict(plan.offsets)
    return {k: dw_flat[offs[k]:offs[k] + w16[k].numel()].view(w16[k].shape)
            for k in _DW_ORDER}


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused train field for device {x.device}")
    return x.device.type


def train_forward(x, w16, emb, residuals: bool = True):
    """K2 on CUDA tensors, its plain version on CPU ones: (raw, residuals),
    the residuals None unless asked for."""
    if _device_of(x) == "cuda":
        with span("kernel.k2"):
            return _launch_fwd(x, w16, emb, residuals)
    return train_forward_plain(x, w16, emb, residuals)


def train_backward(x, g, res, w16, emb):
    """K3 on CUDA tensors, its plain version on CPU ones."""
    if _device_of(x) == "cuda":
        with span("kernel.k3"):
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
    (`pack_field_weights` of the field params, not detached). Where no
    backward can follow (grad off, or no packed weight requires grad) it
    runs K2 without its residual stores, outside autograd; there it takes
    either that f32 pack, which it rounds to bf16, or the pack already
    rounded (`to_bf16`), which it uses as it is."""
    x = _pack_inputs(pts.detach(), dirs.detach())
    emb = emb_constants(cfg, x.device)
    weights = [packed32[k] for k in _DW_ORDER]
    if torch.is_grad_enabled() and any(w.requires_grad for w in weights):
        out = FusedFieldTrain.apply(emb, x, *weights)
    else:
        w16 = packed32 if packed32["w0"].dtype == torch.bfloat16 else to_bf16(packed32)
        out, _ = train_forward(x, w16, emb, residuals=False)
    return out.reshape(*pts.shape[:-1], out.shape[-1])
