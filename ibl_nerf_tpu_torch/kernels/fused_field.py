"""K1: the fused no-grad field query, as CUDA kernels for Hopper.

Counterpart of ibl_nerf_tpu/kernels/fused_field.py (`_field_kernel`,
the Pallas TPU kernel). One launch runs the positional encoding, the
8-layer trunk and either every head or the density only, for a flat
list of points, reading the (N, 8) packed input [pts | dirs | 0-pad]
and writing only the (N, 9+3K) or (N, 1) f32 raw output. The renderer
uses it for the no-gradient sweeps: the 4 ε-offset density sweeps and
the reflected march.

Like the JAX kernel, it computes in the dtype of the packed weights
(`pack_field_weights(..., dtype=)`):
- f32: `csrc/fused_field.cu`, f32 FMA on the CUDA cores, each narrow
  output projection folded into the epilogue of the layer that feeds it
  and reading only the raw columns `projection_columns` names;
- bf16 (the renderer's no-grad dtype under compute_dtype "bfloat16" and
  "mixed"): the embedding rounded to bf16, bf16 products summed in f32,
  every layer rounded to bf16 after its bias and relu, raw in f32, where
  K2 rounds: `csrc/fused_field_bf16.cu`, wgmma over 128-point tiles with
  the weights streamed by TMA, launched by `fused_field_bf16.launch`.

Beside the kernels live their plain PyTorch versions
(`fused_field_apply_plain` / `fused_field_density_plain`, for bf16 packs
`fused_field_train.field_bf16_plain`): the same math from the same
packed weights and the same sin(t + phase) embedding. The wrappers
`fused_field_apply` / `fused_field_density` take the plain version for
CPU tensors only; for CUDA tensors they launch the kernel of the packed
dtype or raise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ibl_nerf_tpu_torch.kernels import build as _build
from ibl_nerf_tpu_torch.models.field import FieldConfig, _assembly_matrices
from ibl_nerf_tpu_torch.ops.embedding import frequency_bands

LANE = 128    # embedding lanes: [pts_emb(63) | dirs_emb(27) | 0-pad]
IN_COLS = 8   # packed kernel input: [pts(3) | dirs(3) | pad(2)]
KERNEL_WIDTH = 256   # trunk width the CUDA kernel's register tiling takes

# Order of the weight pointers handed to the kernel; the enum
# `WeightIndex` in csrc/fused_field.cu lists the same names in the same
# order.
_WEIGHT_ORDER = ["emb_E", "emb_phase", "emb_id",
                 "w0", "w1", "w2", "w3", "w4", "w5x", "w5h", "w6", "w7",
                 "tb", "wpf", "bpf", "wfeat", "bfeat", "wv_f", "wv_d", "bv",
                 "wcf", "bcf", "A", "B", "C", "D", "bias"]

# Launches of the kernel per wrapper and packed dtype; the plain versions
# never count.
LAUNCHES = {"fused_field_apply": 0, "fused_field_density": 0,
            "fused_field_apply_bf16": 0, "fused_field_density_bf16": 0}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_COARSE = 39   # n_out = 9 + 3K <= 128 output lanes, as in the JAX kernel


def projection_columns(n_coarse: int) -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """The raw columns [lo, hi), two ranges each, that every output
    projection may be nonzero in, from the raw layout [σ, albedo3, ρ,
    irr, rad3, coarse3K]: A (σ, ρ), B (albedo, irr), C (rad), then D_k
    (coarse head k). The f32 kernel reads only these columns of each."""
    return ([((0, 1), (4, 5)), ((1, 4), (5, 6)), ((6, 9), (9, 9))]
            + [((9 + 3 * k, 12 + 3 * k), (0, 0)) for k in range(n_coarse)])


def _embedding_constants(cfg: FieldConfig):
    """(E (IN_COLS, LANE), phase (LANE,), id_mask (LANE,)) such that with
    t = x_in @ E the embedding [x, sin(f0 x), cos(f0 x), sin(f1 x), ...]
    of positions then directions is where(id_mask, t, sin(t + phase)).
    Zero columns give sin(0) = 0."""
    E = np.zeros((IN_COLS, LANE), np.float32)
    phase = np.zeros((LANE,), np.float32)
    id_mask = np.zeros((LANE,), np.float32)

    def fill(row0, n_freqs, col0):
        col = col0
        for i in range(3):  # include_input
            E[row0 + i, col + i] = 1.0
            id_mask[col + i] = 1.0
        col += 3
        for f in frequency_bands(n_freqs):
            for trig in range(2):  # sin block then cos block
                for i in range(3):
                    E[row0 + i, col] = f
                    phase[col] = trig * np.pi / 2.0
                    col += 1
        return col

    col = fill(0, cfg.multires, 0)
    fill(3, cfg.multires_views, col)
    return E, phase, id_mask


@functools.cache
def embedding_tensors(cfg: FieldConfig, device: torch.device) -> dict[str, torch.Tensor]:
    """`_embedding_constants` as f32 tensors on `device`, copied there once
    (a copy from host memory waits for the device)."""
    E, phase, id_mask = _embedding_constants(cfg)
    return {"emb_E": torch.from_numpy(E).to(device),
            "emb_phase": torch.from_numpy(phase).to(device),
            "emb_id": torch.from_numpy(id_mask).to(device)}


def _pad_rows(w: torch.Tensor, rows: int, row0: int = 0) -> torch.Tensor:
    out = w.new_zeros((rows, w.shape[1]))
    out[row0:row0 + w.shape[0]] = w
    return out


def pack_field_weights(params: dict, cfg: FieldConfig,
                       dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Field params as the kernel's matrices, on the params' device.

    Takes the default architecture: depth 8, skip at 4, a view branch,
    and an embedding of at most LANE channels (63 + 27 = 90 at multires
    10/4). The skip input rows of layer 5 ([:in_ch], `pts_emb`) and the
    view layer's direction rows (input lanes [in_ch, in_ch+27)) sit at
    their embedding lanes; heads are column-packed to the raw layout.
    As in JAX, the matrices and biases are packed in f32 and then cast to
    `dtype`; the embedding constants stay f32 (sin(2^9 x) needs more
    mantissa than bf16 carries).
    """
    if cfg.depth != 8 or cfg.skips != (4,):
        raise ValueError("the fused field takes depth 8 with the skip at 4")
    if cfg.color_independent_to_direction:
        raise ValueError("the fused field needs the view branch")
    W, K = cfg.width, cfg.coarse_radiance_number
    in_ch, in_views = cfg.input_ch, cfg.input_ch_views
    if in_ch + in_views > LANE:
        raise ValueError(f"embedding of {in_ch + in_views} channels > {LANE}")
    half = W // 2
    n_out = 9 + 3 * K
    device = params["sigma"]["w"].device

    t = params["trunk"]
    packed = {"w0": _pad_rows(t[0]["w"], LANE)}
    for i in (1, 2, 3, 4, 6, 7):
        packed[f"w{i}"] = t[i]["w"]
    # layer 5 consumes [pts_emb | h]: split into input part + h part
    packed["w5x"] = _pad_rows(t[5]["w"][:in_ch], LANE)
    packed["w5h"] = t[5]["w"][in_ch:]
    packed["tb"] = torch.stack([t[i]["b"] for i in range(8)])  # (8, W)

    packed["wpf"] = torch.cat(
        [params["albedo_feat"]["w"], params["irradiance_feat"]["w"]], dim=1)
    packed["bpf"] = torch.cat(
        [params["albedo_feat"]["b"], params["irradiance_feat"]["b"]])
    packed["wfeat"] = params["feature"]["w"]
    packed["bfeat"] = params["feature"]["b"]
    vw = params["views"][0]["w"]  # (W + in_views, W)
    packed["wv_f"] = vw[:W]
    packed["wv_d"] = _pad_rows(vw[W:], LANE, row0=in_ch)
    packed["bv"] = params["views"][0]["b"]
    if K:
        packed["wcf"] = torch.cat([p["w"] for p in params["coarse_feat"]], dim=1)
        packed["bcf"] = torch.cat([p["b"] for p in params["coarse_feat"]])
    else:
        packed["wcf"] = vw.new_zeros((W, half))
        packed["bcf"] = vw.new_zeros((half,))

    # output projections in the raw column layout, shared with the field
    A, B, C, D, bias = _assembly_matrices(params, cfg)
    packed.update(A=A, B=B, C=C, bias=bias,
                  D=D if D is not None else vw.new_zeros((half, n_out)))

    packed = {k: v.to(device=device, dtype=torch.float32).to(dtype).contiguous()
              for k, v in packed.items()}
    packed.update(embedding_tensors(cfg, device))
    return packed


def _pack_inputs(pts: torch.Tensor, dirs: torch.Tensor | None) -> torch.Tensor:
    """(N, 8) f32 kernel input [pts | dirs | 0-pad]; dirs (..., 3) are
    broadcast over the sample axis of pts (..., S, 3)."""
    flat_pts = pts.reshape(-1, 3).float()
    x = flat_pts.new_zeros((flat_pts.shape[0], IN_COLS))
    x[:, 0:3] = flat_pts
    if dirs is not None:
        x[:, 3:6] = dirs[..., None, :].expand(pts.shape).reshape(-1, 3)
    return x


def _field_plain(packed: dict, x: torch.Tensor, density_only: bool) -> torch.Tensor:
    """The kernel's math in PyTorch: (N, 8) -> (N, 9+3K) or (N, 1)."""
    w = packed
    relu = torch.relu
    t = x @ w["emb_E"]
    emb = torch.where(w["emb_id"] > 0.0, t, torch.sin(t + w["emb_phase"]))
    tb = w["tb"]
    h = relu(emb @ w["w0"] + tb[0])
    for i in (1, 2, 3, 4):
        h = relu(h @ w[f"w{i}"] + tb[i])
    h = relu(emb @ w["w5x"] + h @ w["w5h"] + tb[5])
    for i in (6, 7):
        h = relu(h @ w[f"w{i}"] + tb[i])
    if density_only:
        return h @ w["A"][:, 0:1] + w["bias"][0:1]
    pos_feat = relu(h @ w["wpf"] + w["bpf"])
    feature = h @ w["wfeat"] + w["bfeat"]
    h2 = relu(feature @ w["wv_f"] + emb @ w["wv_d"] + w["bv"])
    view_feat = relu(h2 @ w["wcf"] + w["bcf"])
    return (h @ w["A"] + pos_feat @ w["B"] + h2 @ w["C"]
            + view_feat @ w["D"] + w["bias"])


def _packed_dtype(packed: dict) -> torch.dtype:
    """The dtype the fused field computes in: that of the packed w0."""
    dt = packed["w0"].dtype
    if dt not in _DTYPE_NAMES:
        raise ValueError(f"the fused field takes f32 or bf16 packed weights, not {dt}")
    return dt


def _field_plain_any(packed: dict, x: torch.Tensor, density_only: bool) -> torch.Tensor:
    """The plain version for the packed dtype."""
    if _packed_dtype(packed) == torch.bfloat16:
        return _k2().field_bf16_plain(x, packed, _emb(packed), density_only)
    return _field_plain(packed, x, density_only)


def _k2():
    """kernels/fused_field_train, whose plain forward K1's bf16 variant
    shares (imported here: it imports this module)."""
    from ibl_nerf_tpu_torch.kernels import fused_field_train
    return fused_field_train


def _emb(packed: dict) -> dict[str, torch.Tensor]:
    """The embedding constants under the names K2's code takes."""
    return {"E": packed["emb_E"], "phase": packed["emb_phase"], "id": packed["emb_id"]}


def _check(packed: dict, x: torch.Tensor, cfg: FieldConfig) -> None:
    if cfg.width != KERNEL_WIDTH:
        raise ValueError(f"the CUDA kernel takes width {KERNEL_WIDTH}, "
                         f"not {cfg.width}")
    dt = _packed_dtype(packed)
    for k in _WEIGHT_ORDER:
        v = packed[k]
        want = torch.float32 if k.startswith("emb_") else dt
        if v.device != x.device or v.dtype != want or not v.is_contiguous():
            raise ValueError(f"packed weight {k} must be contiguous "
                             f"{_DTYPE_NAMES[want]} on {x.device}, got {v.dtype} "
                             f"on {v.device}")
        if v.data_ptr() % 16:
            raise ValueError(f"packed weight {k} must be 16-byte aligned")
    if cfg.coarse_radiance_number > MAX_COARSE:
        raise ValueError(f"the fused field takes at most {MAX_COARSE} coarse heads")
    n_out = 9 + 3 * cfg.coarse_radiance_number
    if packed["A"].shape != (KERNEL_WIDTH, n_out) or packed["w0"].shape[0] != LANE:
        raise ValueError("packed weights do not match the field config")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != IN_COLS \
            or not x.is_contiguous():
        raise ValueError("kernel input must be contiguous f32 (N, 8)")


# argtypes of `fused_field_launch`
ENTRY_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p]


@functools.cache
def _entry():
    """`fused_field_launch` of csrc/fused_field.cu, built on first use."""
    fn = _build.load("fused_field").fused_field_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ENTRY_ARGS
    return fn


@functools.cache
def _proj_table(n_coarse: int):
    """`projection_columns` as the flat C int array the entry point takes."""
    flat = [c for ranges in projection_columns(n_coarse) for r in ranges for c in r]
    return (ctypes.c_int * len(flat))(*flat)


def occupancy(cfg: FieldConfig, density_only: bool) -> dict[str, int]:
    """The f32 kernel's dynamic shared memory per block and the blocks of
    it an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    for the current CUDA device."""
    fn = _build.load("fused_field").fused_field_occupancy
    fn.restype = ctypes.c_int
    blocks, smem = ctypes.c_int(), ctypes.c_longlong()
    err = fn(cfg.input_ch, cfg.input_ch_views, cfg.coarse_radiance_number,
             int(density_only), ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"fused_field occupancy query failed: error {err}")
    return {"smem_bytes_per_block": smem.value, "blocks_per_sm": blocks.value}


def _launch(packed: dict, x: torch.Tensor, cfg: FieldConfig,
            density_only: bool) -> torch.Tensor:
    _check(packed, x, cfg)
    n = x.shape[0]
    n_cols = 1 if density_only else 9 + 3 * cfg.coarse_radiance_number
    out = torch.empty((n, n_cols), dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * len(_WEIGHT_ORDER))(
        *[packed[k].data_ptr() for k in _WEIGHT_ORDER])
    table = _proj_table(cfg.coarse_radiance_number)
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), n, ctypes.cast(ptrs, ctypes.c_void_p),
                       len(_WEIGHT_ORDER), cfg.width, cfg.input_ch,
                       cfg.input_ch_views, cfg.coarse_radiance_number,
                       int(density_only), ctypes.cast(table, ctypes.c_void_p),
                       len(table) // 4, out.data_ptr(),
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_field kernel launch failed: error {err}")
    LAUNCHES["fused_field_density" if density_only else "fused_field_apply"] += 1
    return out


def _launch_bf16(packed: dict, x: torch.Tensor, cfg: FieldConfig,
                 density_only: bool) -> torch.Tensor:
    from ibl_nerf_tpu_torch.kernels import fused_field_bf16  # it imports this module
    _check(packed, x, cfg)
    out = fused_field_bf16.launch(x, packed, _emb(packed), density_only)
    LAUNCHES["fused_field_density_bf16" if density_only else "fused_field_apply_bf16"] += 1
    return out


def _run(packed, x, cfg, density_only):
    if x.device.type == "cpu":
        return _field_plain_any(packed, x, density_only)
    if x.device.type == "cuda":
        if _packed_dtype(packed) == torch.bfloat16:
            return _launch_bf16(packed, x, cfg, density_only)
        return _launch(packed, x, cfg, density_only)
    raise ValueError(f"no fused field for device {x.device}")


def fused_field_apply(packed: dict, pts: torch.Tensor, dirs: torch.Tensor,
                      cfg: FieldConfig) -> torch.Tensor:
    """Full field query: pts (..., S, 3), dirs (..., 3) -> raw
    (..., S, 9+3K). The kernel on CUDA tensors, the plain version on
    CPU ones."""
    out = _run(packed, _pack_inputs(pts, dirs), cfg, density_only=False)
    return out.reshape(*pts.shape[:-1], out.shape[-1])


def fused_field_density(packed: dict, pts: torch.Tensor,
                        cfg: FieldConfig) -> torch.Tensor:
    """Density-only query: (..., 3) -> raw sigma (..., 1)."""
    out = _run(packed, _pack_inputs(pts, None), cfg, density_only=True)
    return out.reshape(*pts.shape[:-1], 1)


def fused_field_apply_plain(packed: dict, pts: torch.Tensor,
                            dirs: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """The plain PyTorch version of `fused_field_apply`, on any device."""
    out = _field_plain_any(packed, _pack_inputs(pts, dirs), density_only=False)
    return out.reshape(*pts.shape[:-1], out.shape[-1])


def fused_field_density_plain(packed: dict, pts: torch.Tensor,
                              cfg: FieldConfig) -> torch.Tensor:
    """The plain PyTorch version of `fused_field_density`, on any device."""
    out = _field_plain_any(packed, _pack_inputs(pts, None), density_only=True)
    return out.reshape(*pts.shape[:-1], 1)
