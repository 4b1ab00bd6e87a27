"""Operations and bytes of the port's kernels and field queries, from shapes.

The yardstick of the benchmark's `mfu.*` and `roofline.*` metrics. Every
count is worked out from the architecture's published sizes, never read
from the program: a field of `depth` x `width` with its skip at layer 4,
`input_ch` / `input_ch_views` embedding channels and K prefiltered heads.
The formulas are those of the repository's smoke test (`field_macs`,
`train_field_flops`, `k1_bound`, K2's byte count), checked against the
bounds it printed.

Peaks are the H100 SXM data sheet's dense rates at the full 700 W.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "f64": 67e12}
PEAK_BYTES = 3.35e12

IN_COLS = 8      # a kernel's input row: point (3), view direction (3), padding (2)
RESIDUALS = 11   # K2's bf16 residual planes: h0..h7, pos_feat, feat, hv


@dataclasses.dataclass(frozen=True)
class Field:
    width: int = 256
    input_ch: int = 63
    input_ch_views: int = 27
    coarse: int = 3          # K, the prefiltered radiance heads

    @classmethod
    def from_args(cls, args: dict) -> "Field":
        return cls(width=args["netwidth"], input_ch=3 + 6 * args["multires"],
                   input_ch_views=3 + 6 * args["multires_views"],
                   coarse=args["coarse_radiance_number"])

    @property
    def n_out(self) -> int:
        return 9 + 3 * self.coarse


def trunk_macs(f: Field) -> int:
    w = f.width
    return f.input_ch * w + 4 * w * w + (f.input_ch + w) * w + 2 * w * w


def field_macs(f: Field, density_only: bool) -> int:
    """Multiply-adds per point of one field query (no padding, no packed
    zero columns)."""
    w, half, k = f.width, f.width // 2, f.coarse
    if density_only:
        return trunk_macs(f) + w
    heads = (w * w + w * w + (w + f.input_ch_views) * w + w * k * half
             + w + w + 3 * half + half + 3 * w + 3 * k * half)
    return trunk_macs(f) + heads


def k2_flops(f: Field) -> int:
    """FLOPs per point of K2, the training forward."""
    return 2 * field_macs(f, density_only=False)


def k3_flops(f: Field) -> int:
    """FLOPs per point of K3 as it runs: the transposed product of every
    layer not fed by the embedding, every weight product, and the coarse
    features recomputed."""
    w, half = f.width, f.width // 2
    return 2 * (backward_macs(f) + w * f.coarse * half)


def backward_macs(f: Field) -> int:
    """Multiply-adds per point of the field's backward that the gradient
    needs: every weight product and the transposed products of the layers
    whose input carries a gradient (not the embedding's)."""
    w = f.width
    fwd = field_macs(f, density_only=False)
    return 2 * fwd - 2 * f.input_ch * w - f.input_ch_views * w


def field_params(f: Field, density_only: bool = False) -> int:
    """Parameters a query reads (weights and biases)."""
    w, half, k = f.width, f.width // 2, f.coarse
    trunk = trunk_macs(f) + 8 * w
    if density_only:
        return trunk + w + 1
    heads = (w + 1 + w * w + w + (w + f.input_ch_views) * w + w
             + 2 * (w * half + half) + half * 3 + 3 + half + 1 + w + 1 + 3 * w + 3
             + k * (w * half + half + half * 3 + 3))
    return trunk + heads


@dataclasses.dataclass(frozen=True)
class Bound:
    flops: float
    nbytes: float
    dtype: str

    @property
    def seconds(self) -> float:
        """The least time: operations at the dtype's peak or bytes at the
        memory rate, whichever is longer."""
        return max(self.flops / PEAK_FLOPS[self.dtype], self.nbytes / PEAK_BYTES)


def k1_bound(f: Field, points: int, density_only: bool) -> Bound:
    """One K1 launch at f32 weights: each input row, weight and output row
    once."""
    n_cols = 1 if density_only else f.n_out
    nbytes = points * (IN_COLS + n_cols) * 4 + field_params(f, density_only) * 4
    return Bound(2 * field_macs(f, density_only) * points, nbytes, "f32")


def k2_bound(f: Field, points: int) -> Bound:
    """One K2 launch: the input rows, bf16 weights, raw and the bf16
    residual planes it writes."""
    nbytes = (points * (IN_COLS * 4 + f.n_out * 4 + RESIDUALS * f.width * 2)
              + field_params(f) * 2)
    return Bound(k2_flops(f) * points, nbytes, "bf16")


def k3_bound(f: Field, points: int) -> Bound:
    """One K3 launch: the input rows, the cotangent, the residuals and the
    bf16 weights it reads, the f32 weight gradients it writes."""
    nbytes = (points * (IN_COLS * 4 + f.n_out * 4 + RESIDUALS * f.width * 2)
              + field_params(f) * (2 + 4))
    return Bound(k3_flops(f) * points, nbytes, "bf16")


# ---------------------------------------------------------------------------
# The auxiliary heads (models/aux_mlp shapes: depth 8, skip at 4)
# ---------------------------------------------------------------------------

def _aux_trunk_macs(depth: int, width: int, input_ch: int) -> int:
    fan_ins = [input_ch if i == 0 else (width + input_ch if i == 5 else width)
               for i in range(depth)]
    return sum(fan_ins) * width


def position_mlp_macs(depth: int, width: int, input_ch: int, out_ch: int) -> int:
    return _aux_trunk_macs(depth, width, input_ch) + width * out_ch


def position_direction_mlp_macs(depth: int, width: int, input_ch: int,
                                input_ch_views: int, out_ch: int) -> int:
    half = width // 2
    views = (width + input_ch_views) * half + (depth // 2 - 1) * half * half
    return (_aux_trunk_macs(depth, width, input_ch) + width * width + views
            + half * out_ch)


def mlp_backward_macs(fwd_macs: int, width: int, input_ch: int) -> int:
    """Weight products plus the transposed products of every layer but
    the embedding's two inputs (layer 0 and the skip's embedding part)."""
    return 2 * fwd_macs - 2 * input_ch * width


# ---------------------------------------------------------------------------
# The least time of one update or one frame (mfu.*)
# ---------------------------------------------------------------------------

def _query(f: Field, points: int, dtype: str, full: bool, grad: bool) -> list[tuple]:
    macs = field_macs(f, density_only=not full)
    out = [(dtype, 2 * macs * points)]
    if grad:
        out.append((dtype, 2 * backward_macs(f) * points))
    return out


def _aux_heads(args: dict, f: Field, points: int, rays: int) -> list[tuple]:
    """The aux heads' f32 work in one pass of `points` samples (the
    per-sample position heads) and `rays` rays (the depth head)."""
    d, w = args["netdepth"], args["netwidth"]
    out = []
    for flag, ch in (("infer_normal", 3), ("infer_albedo_separate", 3),
                     ("infer_roughness_separate", 1), ("infer_irradiance_separate", 1)):
        if args.get(flag):
            fwd = position_mlp_macs(d, w, f.input_ch, ch)
            out += [("f32", 2 * fwd * points),
                    ("f32", 2 * mlp_backward_macs(fwd, w, f.input_ch) * points)]
    return out


def train_update_work(args: dict, n_rand: int) -> list[tuple]:
    """(dtype, FLOPs) of every field and head query of one update under
    split-sum shading with ground-truth normals and a fine pass: the
    gradient path's full queries of both passes (forward and backward,
    bf16 under bf16_grad), the reflected march of each pass (no grad, the
    sweep dtype), the aux heads of both passes, the depth head on the
    batch and on the depth-volume rays, and the volume pass's
    density-only render."""
    f = Field.from_args(args)
    grad_dt = "bf16" if args["compute_dtype"] in ("bf16_grad", "bfloat16") else "f32"
    sweep_dt = "bf16" if args["compute_dtype"] in ("bfloat16", "mixed") else "f32"
    ns, ni = args["N_samples"], args["N_importance"]
    work = []
    for samples in (ns, ns + ni):
        work += _query(f, n_rand * samples, grad_dt, full=True, grad=True)
        work += _query(f, n_rand * ns, sweep_dt, full=True, grad=False)
        work += _aux_heads(args, f, n_rand * samples, n_rand)
    if args.get("infer_depth"):
        d, w = args["netdepth"], args["netwidth"]
        n_vol = min(args["N_depth_random_volume"], n_rand)
        fwd = position_direction_mlp_macs(d, w, f.input_ch, f.input_ch_views, 1)
        work += [("f32", 2 * fwd * (n_rand + n_vol)),
                 ("f32", 2 * mlp_backward_macs(fwd, w, f.input_ch) * (n_rand + n_vol))]
        work += _query(f, n_vol * (ns + ns + ni), grad_dt, full=False, grad=False)
    return work


def render_frame_work(args: dict, rays: int, eps_normals: bool) -> list[tuple]:
    """(dtype, FLOPs) of one frame of `rays` rays on the fast path: the
    coarse pass density-only (the gradient path's dtype), the fine pass's
    full query (likewise), the reflected march (the sweep dtype) and,
    with ε normals, the four offset density sweeps over the fine
    samples."""
    f = Field.from_args(args)
    grad_dt = "bf16" if args["compute_dtype"] in ("bf16_grad", "bfloat16") else "f32"
    sweep_dt = "bf16" if args["compute_dtype"] in ("bfloat16", "mixed") else "f32"
    ns, ni = args["N_samples"], args["N_importance"]
    work = (_query(f, rays * ns, grad_dt, full=False, grad=False)
            + _query(f, rays * (ns + ni), grad_dt, full=True, grad=False)
            + _query(f, rays * ns, sweep_dt, full=True, grad=False))
    if eps_normals:
        work += _query(f, 4 * rays * (ns + ni), sweep_dt, full=False, grad=False)
    return work


def least_seconds(work: list[tuple]) -> float:
    return sum(flops / PEAK_FLOPS[dt] for dt, flops in work)
