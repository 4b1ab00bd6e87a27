"""The IBL-NeRF neural field.

Counterpart of ibl_nerf_tpu/models/field.py: an 8x256 trunk MLP with a
skip connection at layer 4, plus heads for density sigma(1), albedo(3),
roughness(1), irradiance(1), radiance(3) and K "coarse (prefiltered)
radiance" heads (3 each). Raw output channel layout is
``[sigma, albedo3, rough, irrad, rad3, coarse3*K]``; activations are
applied by the renderer.

Params are a dict of (in, out) tensors mirroring the JAX pytree, so a
JAX checkpoint converts with one numpy round-trip
(`utils.port.field_params_from_numpy`). `freeze_radiance` and
`freeze_roughness` place `.detach()` exactly where the JAX field places
`stop_gradient` (the reference's `forward_freezed`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ibl_nerf_tpu_torch.ops.embedding import embedding_dim
from ibl_nerf_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static architecture config."""

    depth: int = 8
    width: int = 256
    multires: int = 10          # positional-encoding bands for positions
    multires_views: int = 4     # positional-encoding bands for directions
    skips: tuple[int, ...] = (4,)
    coarse_radiance_number: int = 3
    color_independent_to_direction: bool = False

    @property
    def input_ch(self) -> int:
        return embedding_dim(3, self.multires)

    @property
    def input_ch_views(self) -> int:
        return embedding_dim(3, self.multires_views)


def field_raw_channels(cfg: FieldConfig) -> int:
    """sigma(1) + albedo(3) + rough(1) + irrad(1) + rad(3) + K*3."""
    return 9 + 3 * cfg.coarse_radiance_number


def _linear_init(rng: np.random.Generator, fan_in: int, fan_out: int,
                 device: torch.device):
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for both weight and bias."""
    bound = 1.0 / np.sqrt(fan_in)
    w = rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32)
    b = rng.uniform(-bound, bound, (fan_out,)).astype(np.float32)
    return {"w": torch.from_numpy(w).to(device),
            "b": torch.from_numpy(b).to(device)}


def init_field_params(rng: np.random.Generator, cfg: FieldConfig,
                      device: str | torch.device | None = None) -> Params:
    """Random field params drawn from `rng`, on `device` (CUDA unless
    the caller names another)."""
    device = resolve_device(device)
    W, D = cfg.width, cfg.depth
    in_ch, in_ch_views = cfg.input_ch, cfg.input_ch_views
    K = cfg.coarse_radiance_number

    def lin(fan_in, fan_out):
        return _linear_init(rng, fan_in, fan_out, device)

    trunk = []
    for i in range(D):
        fan_in = in_ch if i == 0 else (W + in_ch if (i - 1) in cfg.skips else W)
        trunk.append(lin(fan_in, W))

    return {
        "trunk": trunk,
        "sigma": lin(W, 1),
        "albedo_feat": lin(W, W // 2),
        "albedo": lin(W // 2, 3),
        "roughness": lin(W, 1),
        "irradiance_feat": lin(W, W // 2),
        "irradiance": lin(W // 2, 1),
        "feature": lin(W, W),
        "views": [lin(in_ch_views + W, W)],
        "radiance": lin(W, 3),
        "coarse_feat": [lin(W, W // 2) for _ in range(K)],
        "coarse": [lin(W // 2, 3) for _ in range(K)],
    }


def _mm_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Both operands rounded to bf16, multiplied exactly and summed in f32,
    with an f32 result."""
    return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def _mm(x: torch.Tensor, w: torch.Tensor, amp: bool = False) -> torch.Tensor:
    """Matmul; under `amp` ("automatic mixed precision") only the two
    operands are rounded to bf16, the sum and result are f32: params,
    activations and gradients all stay f32."""
    return _mm_bf16(x, w) if amp else x @ w


def _mm_f32out(x: torch.Tensor, w: torch.Tensor, amp: bool = False) -> torch.Tensor:
    """Matmul whose output keeps f32: bf16 operands (or f32 ones under
    `amp`, rounded to bf16) are multiplied exactly and summed in f32, so
    the raw heads, sigma above all, leave the network at f32 precision;
    f32 and f64 operands take the plain product."""
    if amp or x.dtype == torch.bfloat16:
        return _mm_bf16(x, w)
    return x @ w


def _dense(p, x, amp: bool = False):
    return _mm(x, p["w"], amp) + p["b"]


def _trunk(params: Params, pts_emb: torch.Tensor, cfg: FieldConfig,
           amp: bool = False) -> torch.Tensor:
    h = pts_emb
    for i, layer in enumerate(params["trunk"]):
        h = torch.relu(_dense(layer, h, amp))
        if i in cfg.skips:
            h = torch.cat([pts_emb, h], dim=-1)
    return h


def _pos_features(params: Params, h: torch.Tensor, amp: bool = False) -> torch.Tensor:
    """Fused position-branch feature heads: (N, 2·half) =
    relu(h @ [albedo_feat | irradiance_feat])."""
    wf = torch.cat([params["albedo_feat"]["w"], params["irradiance_feat"]["w"]], dim=1)
    bf = torch.cat([params["albedo_feat"]["b"], params["irradiance_feat"]["b"]], dim=0)
    return torch.relu(_mm(h, wf, amp) + bf)


def _coarse_features(params: Params, h2: torch.Tensor,
                     amp: bool = False) -> torch.Tensor | None:
    """Fused K coarse-radiance feature heads: (N, K·half)."""
    if not params["coarse_feat"]:
        return None
    wf = torch.cat([p["w"] for p in params["coarse_feat"]], dim=1)
    bf = torch.cat([p["b"] for p in params["coarse_feat"]], dim=0)
    return torch.relu(_mm(h2, wf, amp) + bf)


def _zero_cols(w: torch.Tensor, n: int) -> torch.Tensor:
    return w.new_zeros((w.shape[0], n))


def _keep(x):
    return x


def _assembly_matrices(params: Params, cfg: FieldConfig,
                       freeze_radiance: bool = False,
                       freeze_roughness: bool = False):
    """Column-packed output projections: the raw layout
    [σ, albedo3, ρ, irrad, rad3, coarse3K] is h@A + pos_feat@B + h2@C +
    view_feat@D + bias.

    Freezing detaches columns: σ and radiance (and the coarse heads) under
    freeze_radiance, roughness only under both flags. A detached column
    whose input is detached too is "computed under no_grad"."""
    K = cfg.coarse_radiance_number
    s_rad = torch.Tensor.detach if freeze_radiance else _keep
    s_rough = torch.Tensor.detach if freeze_radiance and freeze_roughness else _keep
    w_sig, w_rough = s_rad(params["sigma"]["w"]), s_rough(params["roughness"]["w"])
    A = torch.cat([w_sig, _zero_cols(w_sig, 3), w_rough,
                   _zero_cols(w_sig, 4 + 3 * K)], dim=1)

    w_alb, w_irr = params["albedo"]["w"], params["irradiance"]["w"]
    B = torch.cat([
        torch.cat([_zero_cols(w_alb, 1), w_alb, _zero_cols(w_alb, 5 + 3 * K)], dim=1),
        torch.cat([_zero_cols(w_irr, 5), w_irr, _zero_cols(w_irr, 3 + 3 * K)], dim=1),
    ], dim=0)

    w_rad = s_rad(params["radiance"]["w"])
    C = torch.cat([_zero_cols(w_rad, 6), w_rad, _zero_cols(w_rad, 3 * K)], dim=1)

    D = None
    if K:
        D = torch.cat([
            torch.cat([_zero_cols(p["w"], 9 + 3 * k), s_rad(p["w"]),
                       _zero_cols(p["w"], 3 * (K - k - 1))], dim=1)
            for k, p in enumerate(params["coarse"])], dim=0)  # (K*half, n_out)

    bias = torch.cat(
        [s_rad(params["sigma"]["b"]), params["albedo"]["b"],
         s_rough(params["roughness"]["b"]), params["irradiance"]["b"],
         s_rad(params["radiance"]["b"])]
        + [s_rad(p["b"]) for p in params["coarse"]], dim=0)
    return A, B, C, D, bias


def apply_field_density(params: Params, pts_emb: torch.Tensor,
                        cfg: FieldConfig,
                        freeze_radiance: bool = False,
                        amp: bool = False) -> torch.Tensor:
    """Density-only query: raw sigma (..., 1). Under freeze_radiance the
    trunk and sigma carry no gradient."""
    h = _trunk(params, pts_emb, cfg, amp)
    sigma = _mm_f32out(h, params["sigma"]["w"], amp) + params["sigma"]["b"]
    return sigma.detach() if freeze_radiance else sigma


def apply_field(params: Params, pts_emb: torch.Tensor, dirs_emb: torch.Tensor,
                cfg: FieldConfig, freeze_radiance: bool = False,
                freeze_roughness: bool = False, amp: bool = False) -> torch.Tensor:
    """Full field query -> raw (..., 9 + 3K).

    Under freeze_radiance the trunk, sigma, radiance, the view branch and
    the coarse heads carry no gradient; albedo and irradiance train their
    own heads only; roughness is frozen too under freeze_roughness. Under
    `amp` every matmul rounds its operands to bf16 and sums in f32.
    """
    W = params["feature"]["w"].shape[0]
    h = _trunk(params, pts_emb, cfg, amp)
    h_heads = h.detach() if freeze_radiance else h
    pos_feat = _pos_features(params, h_heads, amp)

    if cfg.color_independent_to_direction:
        h2 = h_heads
    else:
        feat = _dense(params["feature"], h_heads, amp)
        vw, vb = params["views"][0]["w"], params["views"][0]["b"]
        h2 = torch.relu(_mm(feat, vw[:W], amp) + _mm(dirs_emb, vw[W:], amp) + vb)
        for layer in params["views"][1:]:
            h2 = torch.relu(_dense(layer, h2, amp))

    view_feat = _coarse_features(params, h2, amp)
    A, B, C, D, bias = _assembly_matrices(params, cfg, freeze_radiance,
                                          freeze_roughness)
    # under freeze the radiance and coarse columns are dead ends for the
    # view branch too: its inputs to them are detached
    h2_in = h2.detach() if freeze_radiance else h2
    raw = (_mm_f32out(h_heads, A, amp) + _mm_f32out(pos_feat, B, amp)
           + _mm_f32out(h2_in, C, amp) + bias)
    if view_feat is not None:
        vf_in = view_feat.detach() if freeze_radiance else view_feat
        raw = raw + _mm_f32out(vf_in, D, amp)
    return raw
