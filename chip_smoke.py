#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ibl_nerf_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, one JSON line each; any failure exits non-zero:
  device  the card's name and power limit (nvidia-smi); fails without CUDA.
  build   nvcc builds every kernel source of the path, all at once.
  kernel  each kernel against its plain PyTorch version on the card at
          the shapes the main path gives it, and at a ragged point count:
          errors against the stated tolerance, kernel and plain times
          (CUDA events, after warm-up), and the least time the card could
          take (FLOPs over the f32 rate, bytes over the memory rate).
  slice   the main path — `render_path` at full width (8x256 field, K=3,
          64+128 samples, ε-normals, split-sum, bf16_grad, K1 on the
          no-grad sweeps, chunks of 2048 rays) over two 160x120 poses
          with weights from a seed — with the kernels' launch counts
          zeroed before it and read after it; every exported buffer must
          be finite, and one chunk must match the eager path's render.
Then the per-kernel JSON line, the card line, and the ok line last.
Every number printed is measured in this run, on this card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.eval.render_path import render_path
from ibl_nerf_tpu_torch.kernels import build as kernel_build
from ibl_nerf_tpu_torch.kernels import fused_field as ff
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.ops.rays import get_rays_full_image
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.utils.device import resolve_device

# H100 SXM data-sheet rates at the full 700 W: f32 outside the tensor
# cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# K1 against its plain version: both sum f32 products, in other orders
# (the kernel by FMA chains, cuBLAS by its own blocking).
KERNEL_ATOL, KERNEL_RTOL = 2e-6, 1e-4
# One 2048-ray chunk on K1 against the eager path (use_pallas=False):
# shaded maps, the repo's shaded-map bound.
SLICE_ATOL, SLICE_RTOL = 2e-3, 5e-3

CHUNK = 2048
H, W, N_POSES = 120, 160, 2
SEED = 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(phase: str, msg: str) -> None:
    emit(phase, ok=False, error=msg)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def field_macs(cfg: FieldConfig, density_only: bool) -> int:
    """Multiply-adds per point that the field needs (zero padding and
    the packed heads' zero columns not counted)."""
    w, half, k = cfg.width, cfg.width // 2, cfg.coarse_radiance_number
    trunk = cfg.input_ch * w + 4 * w * w + (cfg.input_ch + w) * w + 2 * w * w
    if density_only:
        return trunk + w
    heads = (w * w + w * w + (w + cfg.input_ch_views) * w + w * k * half
             + w + w + 3 * half + half + 3 * w + 3 * k * half)
    return trunk + heads


def time_ms(fn, iters: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(cfg, packed, gen) -> list[dict]:
    """Both variants of K1 against the plain version."""
    rays, n_samples = CHUNK, 64 + 128
    variants = [
        # (wrapper, points of one launch on the main path, with dirs?)
        ("fused_field_density", (4 * rays, n_samples), False),
        ("fused_field_apply", (rays, 64), True),
    ]
    report = []
    for name, shape, with_dirs in variants:
        n_pts = shape[0] * shape[1]
        n_cols = 9 + 3 * cfg.coarse_radiance_number if with_dirs else 1
        read = (ff._WEIGHT_ORDER if with_dirs else
                ["emb_E", "emb_phase", "emb_id", "w0", "w1", "w2", "w3", "w4",
                 "w5x", "w5h", "w6", "w7", "tb", "A", "bias"])
        weight_bytes = sum(packed[k].numel() * 4 for k in read)

        def inputs(lead):
            pts = torch.rand((*lead, 3), device="cuda", generator=gen) * 4 - 2
            dirs = torch.nn.functional.normalize(
                torch.randn((lead[0], 3), device="cuda", generator=gen), dim=-1)
            return pts, dirs

        def calls(pts, dirs):
            if with_dirs:
                return (lambda: ff.fused_field_apply(packed, pts, dirs, cfg),
                        lambda: ff.fused_field_apply_plain(packed, pts, dirs, cfg))
            return (lambda: ff.fused_field_density(packed, pts, cfg),
                    lambda: ff.fused_field_density_plain(packed, pts, cfg))

        max_abs = max_rel = 0.0
        # ragged (+37 points, not a multiple of the tile), then main-path shape
        for lead in ((n_pts + 37, 1), shape):
            kern, plain = calls(*inputs(lead))
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail("kernel", f"{name}: non-finite output at {lead}")
            err = (out - ref).abs()
            bad = err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()
            if bad.any():
                fail("kernel", f"{name} at {lead}: {int(bad.sum())} values off, "
                     f"max abs err {err.max().item():.3e}")
            max_abs = max(max_abs, err.max().item())
            # relative to |plain|, floored at 1e-3 so values near 0 do not blow it up
            max_rel = max(max_rel, (err / ref.abs().clamp_min(1e-3)).max().item())

        # timing at the main path's shape, in turns: plain, kernel, kernel, plain
        iters = 5
        kern(), plain()
        p1, k1, k2, p2 = (time_ms(plain, iters), time_ms(kern, iters),
                          time_ms(kern, iters), time_ms(plain, iters))
        flops = 2 * field_macs(cfg, density_only=not with_dirs) * n_pts
        nbytes = n_pts * (ff.IN_COLS + n_cols) * 4 + weight_bytes
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        report.append({
            "name": name, "route": "cuda",
            "source": "ibl_nerf_tpu_torch/csrc/fused_field.cu",
            "replaces": "ibl_nerf_tpu/kernels/fused_field.py:206",
            "launches": None, "max_abs_err": max_abs,
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        emit("kernel", name=name, points=n_pts, flops=flops, bytes=nbytes,
             max_abs_err=max_abs, max_rel_err=max_rel, atol=KERNEL_ATOL,
             rtol=KERNEL_RTOL,
             ms=[k1, k2], plain_ms=[p1, p2], bound_ms=max(t_ops, t_bytes),
             tflops=flops / ((k1 + k2) / 2) / 1e9)
    return report


def _look_at(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world (3, 4) at `eye` looking at the origin (-z forward)."""
    z = eye / np.linalg.norm(eye)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], axis=1).astype(np.float32)


class Scene:
    """Two 160x120 poses on a circle of radius 4 around the origin."""
    height, width, near, far = H, W, 2.0, 6.0
    focal = 0.5 * W / np.tan(0.5 * np.radians(50.0))
    poses = np.stack([_look_at(np.array([4 * np.sin(a), 0.5, 4 * np.cos(a)]))
                      for a in np.linspace(0.0, 1.0, N_POSES)])

    def gt_buffers(self):
        return {}


def slice_phase(cfg, variables, consts, kernels, card: str) -> None:
    rcfg = RenderConfig(
        field=cfg, n_samples=64, n_importance=128, perturb=False,
        approximate_radiance=True,
        normal_type="normal_map_from_depth_gradient_epsilon",
        correct_depth_for_prefiltered_radiance_infer=True,
        compute_dtype="bf16_grad", use_pallas=True, coarse_shading=False)
    scene = Scene()

    # one chunk of pose 0: K1 against the eager path (also the warm-up)
    K = torch.tensor([[scene.focal, 0, 0.5 * W], [0, scene.focal, 0.5 * H],
                      [0, 0, 1]], dtype=torch.float32, device="cuda")
    ro, rd = get_rays_full_image(H, W, K, torch.from_numpy(scene.poses[0]).cuda())
    batch = make_ray_batch(ro.reshape(-1, 3)[:CHUNK], rd.reshape(-1, 3)[:CHUNK],
                           scene.near, scene.far)
    out_k1 = render_rays(variables, consts, batch, rcfg)
    out_eager = render_rays(variables, consts, batch, rcfg.replace(use_pallas=False))
    chunk_err = {}
    for k in ("color_map", "target_normal_map", "reflected_radiance_map"):
        a, b = out_k1[k], out_eager[k]
        err = (a - b).abs()
        chunk_err[k] = err.max().item()
        if not torch.isfinite(a).all() or (err > SLICE_ATOL + SLICE_RTOL * b.abs()).any():
            fail("slice", f"{k}: K1 render differs from the eager render, "
                 f"max abs err {chunk_err[k]:.3e}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    render_rays(variables, consts, batch, rcfg)
    end.record()
    torch.cuda.synchronize()
    chunk_ms_events = start.elapsed_time(end)

    # the main path, with the launch counts zeroed just before it
    for k in ff.LAUNCHES:
        ff.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = render_path(variables, consts, scene, rcfg, chunk=CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ff.LAUNCHES)

    n_chunks = N_POSES * -(-(H * W) // CHUNK)
    for name, count in launches.items():
        if count != n_chunks:
            fail("slice", f"{name} launched {count} times, expected one per "
                 f"chunk ({n_chunks})")
    for row in kernels:
        row["launches"] = launches[row["name"]]
    for k, v in results.items():
        if v.shape[:3] != (N_POSES, H, W) or not np.isfinite(v).all():
            fail("slice", f"buffer {k}: shape {v.shape} or non-finite values")
    for k in ("rgb", "target_normal_map", "reflected_radiance", "depth", "acc"):
        if k not in results:
            fail("slice", f"buffer {k} missing")
    k1_ms = sum(r["ms"] for r in kernels)
    emit("slice", card=card, poses=N_POSES, height=H, width=W, chunk=CHUNK,
         chunks=n_chunks, seconds=seconds,
         rays_per_s=N_POSES * H * W / seconds,
         ms_per_chunk=seconds / n_chunks * 1e3,
         chunk_ms_cuda_events=chunk_ms_events,
         k1_ms_per_chunk_from_kernel_phase=k1_ms,
         launches=launches, buffers=sorted(results),
         chunk_vs_eager_max_abs_err=chunk_err,
         atol=SLICE_ATOL, rtol=SLICE_RTOL)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    device = resolve_device("cuda")
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    kernel_build.build()
    report = {name: [ln for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
              for name, log in kernel_build.build_logs.items()}
    emit("build", seconds=time.perf_counter() - t0, sources=list(kernel_build.SOURCES),
         ptxas=report)

    cfg = FieldConfig(depth=8, width=256, coarse_radiance_number=3)
    rng = np.random.default_rng(SEED)
    variables = {"coarse": init_field_params(rng, cfg, device),
                 "fine": init_field_params(rng, cfg, device)}
    for v in variables.values():  # visible density, so depth and normals mean something
        v["sigma"]["b"] += 0.5
    consts = {"brdf_lut": load_brdf_lut(device=device)}
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    kernels = kernel_phase(cfg, ff.pack_field_weights(variables["fine"], cfg), gen)
    slice_phase(cfg, variables, consts, kernels, card)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
