#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ibl_nerf_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, one JSON line each; any failure exits non-zero:
  device  the card's name and power limit (nvidia-smi); fails without CUDA.
  build   nvcc builds every kernel source, one process per source, at once.
  kernel  each kernel against its plain PyTorch version on the card at the
          shapes the main paths give it, and at ragged point counts:
          K1 (both variants, at f32 weights and at bf16 weights, each
          with its shared memory per block, resident blocks per SM (at
          least 2 for f32) and ptxas registers and spills; K1 full at f32
          also at the train step's 512 x 64 points and with 0, 1 and 2
          coarse heads; K1 at bf16 weights also against K2's raw), K2
          (raw and the 11 residuals) and K3 (the 24 weight gradients), the
          bf16 ones each with two runs bit-identical;
          errors against the stated tolerance, kernel and plain times (CUDA
          events, after warm-up), and the least time the card could take
          (FLOPs over the f32 or bf16 tensor-core rate, bytes over the
          memory rate); K2's and K3's time by stage (torch.profiler) beside
          their designs' floors. Also
          the field gradients of K2/K3 and of the eager bf16 query against
          the eager f32 one.
  slice   the serving path -- `render_path` at full width (8x256 field,
          K=3, 64+128 samples, ε-normals, split-sum, bf16_grad, K1 on the
          no-grad sweeps, chunks of 2048 rays) over two 160x120 poses --
          with the launch counts zeroed before it and read after it; every
          exported buffer must be finite, and one chunk must match the
          eager path's render.
  train   the training path -- bench.py's workload with BENCH_PTRAIN=1
          (512 rays, 64+128 samples, sgs normals, bf16_grad, K2/K3 on the
          gradient path of both passes, K1 on the reflected march, Adam)
          on a synthetic 8x480x640 scene: 3 warm-up steps; the kernel
          path's gradients against the eager paths' on one step from
          their state, with its importance samples and sgs normals held
          fixed; three windows of timed steps with the launch counts
          zeroed before them (2 K2, 2 K3 and 2 K1 full per step) and the
          host's time per launched operation beside each; finite loss
          and params; a profiler breakdown.
  slice_bf16  the serving path under compute_dtype bfloat16 (every query
          bf16, K1's bf16-weight variant on the no-grad sweeps) over the
          same poses: 1 K1-bf16 density and 1 K1-bf16 full launch per
          chunk and no f32 K1 launch; one chunk against the f32 render
          within JAX's bf16 bound (atol 0.1 on four maps).
  train_mixed scripts/perf_sweep.py's mixed:pallas step (512 rays,
          ε-normals, eager f32 gradient path, K1-bf16 on the no-grad
          sweeps): 3 warm-up and 10 timed steps, 2 launches of each
          K1-bf16 mode per step, finite loss and f32 params; a profiler
          breakdown.
Weights are random from a seed. Then the per-kernel JSON line, the card
line, and the ok line last. Every number printed is measured in this
run, on this card.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.eval.render_path import render_path
from ibl_nerf_tpu_torch.kernels import build as kernel_build
from ibl_nerf_tpu_torch.kernels import fused_field as ff
from ibl_nerf_tpu_torch.kernels import fused_field_bf16 as k1b
from ibl_nerf_tpu_torch.kernels import fused_field_train as fft
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.ops.rays import get_rays_full_image
from ibl_nerf_tpu_torch.render import RenderConfig, make_ray_batch, render_rays
from ibl_nerf_tpu_torch.render import normals as normals_mod
from ibl_nerf_tpu_torch.render import renderer
from ibl_nerf_tpu_torch.train import (
    LossConfig,
    build_optimizer,
    init_train_state,
    make_train_step,
    resolve_phase,
)
from ibl_nerf_tpu_torch.train.step import _leaves
from ibl_nerf_tpu_torch.utils.device import resolve_device

# H100 SXM data-sheet rates at the full 700 W: f32 outside the tensor
# cores, bf16 on the tensor cores (dense), and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# K1 against its plain version: both sum f32 products, in other orders
# (the kernel by FMA chains, cuBLAS by its own blocking).
KERNEL_ATOL, KERNEL_RTOL = 2e-6, 1e-4
# One 2048-ray chunk on K1 against the eager path (use_pallas=False):
# shaded maps, the repo's shaded-map bound.
SLICE_ATOL, SLICE_RTOL = 2e-3, 5e-3
# A chunk rendered under compute_dtype bfloat16 against the f32 render:
# JAX's own bound for the bf16 modes (tests/test_dtypes.py: bf16 matmuls
# keep ~3 decimal digits; depth scales with the far plane).
BF16_ATOL = 0.1
BF16_MAPS = ("color_map", "radiance_map", "albedo_map", "depth_map")

# K2/K3 against their plain versions, per output block: ||kernel - plain||
# / ||plain||. Both round every activation and delta to bf16 after an f32
# sum taken in another order (mma.sync against cuBLAS), so an element near
# a rounding tie can land on the neighbouring bf16 value (2^-8 relative)
# and carry that into the later layers; such flips stay below 1e-3 of a
# block's norm, while a wrong row, mask or offset gives O(1).
TRAIN_KERNEL_REL = 1e-2

# The kernel path's gradient error against f32 may be at most this many
# times the eager bf16 path's (the criterion of tests/test_kernels.py for
# the JAX kernel): in the kernel phase on the same points and cotangent,
# and in the train phase for one step from the same state and draws.
# That step is chaotic in two of its forward values: the importance
# samples move when a bf16 coarse weight crosses a draw, and the sgs
# normal is the gradient of the bf16 density; left free, both bf16 paths
# sit 5-30% from f32 and their ratio swung from 0.35 to 2.55 per draw,
# and from 0.94 to 2.07 as the mean of 16 draws. So the gated step, at
# the slice's settings, takes both from the f32 path (`held_inputs`); the
# free step's errors are printed beside it. What stays chaotic (relu on a
# density near 0, the LUT's texels, the mip levels) still moves one
# draw's ratio by 2x, and it grows as training moves the random field,
# so the gate takes the ratio of the mean errors over 32 draws from the
# state after the warm-up steps.
GRAD_RATIO = 1.3
GRAD_DRAWS = 32

CHUNK = 2048
H, W, N_POSES = 120, 160, 2
SEED = 0

# The train phase: bench.py's workload with BENCH_PTRAIN=1 (512 rays,
# 64 + 128 samples, sgs normals, bf16_grad, K2/K3 on the gradient path,
# K1 on the reflected march) on its synthetic Kitchen-shaped scene.
N_RAND = 512
TRAIN_H, TRAIN_W, TRAIN_IMAGES = 480, 640, 8
WARMUP_STEPS, WINDOWS, WINDOW_STEPS = 3, 3, 30
# The train_mixed phase: scripts/perf_sweep.py's mixed:pallas step.
MIXED_STEPS = 10


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


def stage_ms(fn, prefix: str, iters: int = 5) -> dict:
    """Device ms per call of each kernel whose name holds `prefix` (the
    stages of one wrapper call), from torch.profiler over `iters` calls
    after a warm-up; empty when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        found = re.search(prefix + r"\w*", ev.key)
        if ev.device_type != torch.autograd.DeviceType.CUDA or not found:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        out[found.group(0)] = out.get(found.group(0), 0.0) + us / 1e3 / iters
    return out


# K1's wrappers: (name, points of one launch on the serving path, with dirs?)
# -- the 4 ε-offset sweeps of a 2048-ray chunk over 64 + 128 samples, and
# the reflected march over its 64 coarse samples.
K1_VARIANTS = [
    ("fused_field_density", (4 * CHUNK, 64 + 128), False),
    ("fused_field_apply", (CHUNK, 64), True),
]
K1_SOURCE = "ibl_nerf_tpu/kernels/fused_field.py:206"
K1_BF16_SOURCE = "ibl_nerf_tpu_torch/csrc/fused_field_bf16.cu"
# K1 full's launch on the training step's reflected march: 512 rays x 64
# coarse samples.
K1_TRAIN_SHAPE = (N_RAND, 64)
# Resident blocks per SM that the f32 K1's design promises for both variants
# (csrc/fused_field.cu: shared memory and registers sized for two).
K1_BLOCKS_PER_SM = 2


def k1_ptxas(log: str, kernel: str = "fused_field_kernel") -> dict:
    """{"density" | "full": {registers, spill_stores, spill_loads}} of the
    two variants of a K1 kernel (the f32 one, or "k1_bf16_field"), from
    nvcc's -Xptxas -v output of its source."""
    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            entry = (("density" if "ILb1E" in m.group(1) else "full")
                     if kernel in m.group(1) else None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and entry:
            out.setdefault(entry, {}).update(spill_stores=int(m.group(1)),
                                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def k1_inputs(lead, gen):
    pts = torch.rand((*lead, 3), device="cuda", generator=gen) * 4 - 2
    dirs = torch.nn.functional.normalize(
        torch.randn((lead[0], 3), device="cuda", generator=gen), dim=-1)
    return pts, dirs


def k1_calls(packed, cfg, pts, dirs, with_dirs):
    """(kernel, plain version) of one K1 wrapper on these inputs."""
    if with_dirs:
        return (lambda: ff.fused_field_apply(packed, pts, dirs, cfg),
                lambda: ff.fused_field_apply_plain(packed, pts, dirs, cfg))
    return (lambda: ff.fused_field_density(packed, pts, cfg),
            lambda: ff.fused_field_density_plain(packed, pts, cfg))


def k1_check(name, kern, plain, lead):
    """K1 against its plain version on one launch: (max abs, max rel)
    error; fails the phase outside the gate."""
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail("kernel", f"{name}: non-finite output at {lead}")
    err = (out - ref).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()
    if bad.any():
        fail("kernel", f"{name} at {lead}: {int(bad.sum())} values off, "
             f"max abs err {err.max().item():.3e}")
    # relative to |plain|, floored at 1e-3 so values near 0 do not blow it up
    return err.max().item(), (err / ref.abs().clamp_min(1e-3)).max().item()


def k1_head_counts(cfg, gen) -> dict:
    """K1 full at f32 weights with 0, 1 and 2 coarse heads (no view_feat
    tile, a lone 128-column tile, one 256-column tile; the main path has
    3) against the plain version on a ragged count: max abs error each."""
    errs = {}
    for k in (0, 1, 2):
        kcfg = FieldConfig(depth=cfg.depth, width=cfg.width, coarse_radiance_number=k)
        params = init_field_params(np.random.default_rng(SEED + k), kcfg, "cuda")
        kern, plain = k1_calls(ff.pack_field_weights(params, kcfg), kcfg,
                               *k1_inputs((4097, 1), gen), True)
        errs[k] = k1_check(f"fused_field_apply at K={k}", kern, plain, (4097, 1))[0]
    return errs


def kernel_phase(cfg, packed, gen) -> list[dict]:
    """Both variants of K1 against the plain version, with their shared
    memory, resident blocks per SM and registers; K1 full also at the
    train step's shape."""
    ptxas = k1_ptxas(kernel_build.build_logs.get("fused_field", ""))
    report = []
    for name, shape, with_dirs in K1_VARIANTS:
        n_pts = shape[0] * shape[1]
        n_cols = 9 + 3 * cfg.coarse_radiance_number if with_dirs else 1
        read = (ff._WEIGHT_ORDER if with_dirs else
                ["emb_E", "emb_phase", "emb_id", "w0", "w1", "w2", "w3", "w4",
                 "w5x", "w5h", "w6", "w7", "tb", "A", "bias"])
        weight_bytes = sum(packed[k].numel() * 4 for k in read)

        occupancy = ff.occupancy(cfg, density_only=not with_dirs)
        if occupancy["blocks_per_sm"] < K1_BLOCKS_PER_SM:
            fail("kernel", f"{name}: {occupancy['blocks_per_sm']} resident blocks per SM, "
                 f"the design needs {K1_BLOCKS_PER_SM}")

        def bound(points):
            flops = 2 * field_macs(cfg, density_only=not with_dirs) * points
            nbytes = points * (ff.IN_COLS + n_cols) * 4 + weight_bytes
            return flops, nbytes, flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3

        max_abs = max_rel = 0.0
        # the train step's shape (full only), ragged (+37 points, not a
        # multiple of the tile), then the main path's shape
        train = None
        if with_dirs:
            kern, plain = k1_calls(packed, cfg, *k1_inputs(K1_TRAIN_SHAPE, gen), with_dirs)
            max_abs, max_rel = k1_check(name, kern, plain, K1_TRAIN_SHAPE)
            kern(), plain()
            p1, k1, k2, p2 = (time_ms(plain, 10), time_ms(kern, 10),
                              time_ms(kern, 10), time_ms(plain, 10))
            n_train = K1_TRAIN_SHAPE[0] * K1_TRAIN_SHAPE[1]
            train = dict(points=n_train, ms=[k1, k2], plain_ms=[p1, p2],
                         bound_ms=max(bound(n_train)[2:]))
        for lead in ((n_pts + 37, 1), shape):
            kern, plain = k1_calls(packed, cfg, *k1_inputs(lead, gen), with_dirs)
            e_abs, e_rel = k1_check(name, kern, plain, lead)
            max_abs, max_rel = max(max_abs, e_abs), max(max_rel, e_rel)

        # timing at the main path's shape, in turns: plain, kernel, kernel, plain
        iters = 5
        kern(), plain()
        p1, k1, k2, p2 = (time_ms(plain, iters), time_ms(kern, iters),
                          time_ms(kern, iters), time_ms(plain, iters))
        flops, nbytes, t_ops, t_bytes = bound(n_pts)
        report.append({
            "name": name, "route": "cuda",
            "source": "ibl_nerf_tpu_torch/csrc/fused_field.cu",
            "replaces": K1_SOURCE,
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
             tflops=flops / ((k1 + k2) / 2) / 1e9, **occupancy,
             ptxas=ptxas.get("density" if not with_dirs else "full", "not built in this run"),
             train_shape=train,
             other_head_counts_max_abs_err=k1_head_counts(cfg, gen) if with_dirs else None)
    return report


def k1_bf16_head_counts(cfg, gen, with_dirs: bool) -> dict:
    """K1 at bf16 weights with 4 and 7 coarse heads (vf in two and in
    four passes, 21 and 30 head columns; the main path has 3) against its
    plain version on a ragged count, in relative norm under
    TRAIN_KERNEL_REL, twice bit-identical: the error at each K."""
    errs = {}
    for k in (4, 7):
        kcfg = FieldConfig(depth=cfg.depth, width=cfg.width, coarse_radiance_number=k)
        params = init_field_params(np.random.default_rng(SEED + k), kcfg, "cuda")
        params["sigma"]["b"] += 0.5
        packed = ff.pack_field_weights(params, kcfg, dtype=torch.bfloat16)
        kern, plain = k1_calls(packed, kcfg, *k1_inputs((4097, 1), gen), with_dirs)
        out, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        errs[k] = rel_err(out, ref)
        if not (torch.isfinite(out).all() and torch.equal(out, again)
                and errs[k] <= TRAIN_KERNEL_REL):
            fail("kernel", f"K1-bf16 ({'full' if with_dirs else 'density'}) at K={k}: "
                 f"{errs[k]:.3e} relative from its plain version (bound "
                 f"{TRAIN_KERNEL_REL}), finite and rerun-identical required")
    return errs


def k1_bf16_kernel_phase(cfg, params, gen) -> list[dict]:
    """K1's bf16-weight variant, both modes, at the shapes of the serving
    path under compute_dtype bfloat16 and at ragged counts (+37): against
    its plain version per output in relative norm (it rounds where K2 does
    and sums in another order, so TRAIN_KERNEL_REL), against K2's raw on
    the same input under the same bound (full: raw; density: raw[:, 0]),
    twice bit-identical, and at K = 4 and 7 (`k1_bf16_head_counts`); with
    its shared memory per block, blocks per SM and ptxas registers and
    spills."""
    packed = ff.pack_field_weights(params, cfg, dtype=torch.bfloat16)
    emb = fft.emb_constants(cfg, torch.device("cuda"))
    n_out = 9 + 3 * cfg.coarse_radiance_number
    ptxas = k1_ptxas(kernel_build.build_logs.get("fused_field_bf16", ""), "k1_bf16_field")
    report = []
    for name, shape, with_dirs in K1_VARIANTS:
        name = name + "_bf16"
        n_pts = shape[0] * shape[1]
        n_cols = n_out if with_dirs else 1
        sched, n_slabs = (fft.forward_schedule if with_dirs else fft.density_schedule)(
            fft._shapes(packed))
        read = {w for w, *_ in sched} | {"tb", "bias", "emb_E", "emb_phase", "emb_id"}
        if with_dirs:
            read |= {"bpf", "bfeat", "bv", "bcf"}
        weight_bytes = sum(packed[k].numel() * packed[k].element_size() for k in read)
        occupancy = k1b.occupancy(density_only=not with_dirs)
        if occupancy["blocks_per_sm"] < 1:
            fail("kernel", f"{name}: {occupancy}, no block fits an SM")

        errs, errs_k2, max_abs = {}, {}, 0.0
        for lead in ((n_pts + 37, 1), shape):
            pts, dirs = k1_inputs(lead, gen)
            kern, plain = k1_calls(packed, cfg, pts, dirs, with_dirs)
            out, again, ref = kern(), kern(), plain()
            raw_k2, res = fft._launch_fwd(ff._pack_inputs(pts, dirs if with_dirs else None),
                                          packed, emb)
            torch.cuda.synchronize()
            n_lead = lead[0] * lead[1]
            errs_k2[n_lead] = rel_err(out.reshape(-1, n_cols), raw_k2[:, :n_cols])
            del raw_k2, res
            if not torch.isfinite(out).all():
                fail("kernel", f"{name}: non-finite output at {lead}")
            if not torch.equal(out, again):
                fail("kernel", f"{name}: two runs on the same inputs differ at {lead}")
            errs[n_lead] = rel_err(out, ref)
            for what, err in (("its plain version", errs[n_lead]), ("K2's raw", errs_k2[n_lead])):
                if not err <= TRAIN_KERNEL_REL:
                    fail("kernel", f"{name} at {lead}: off {what} by {err:.3e} relative "
                         f"(bound {TRAIN_KERNEL_REL})")
            max_abs = max(max_abs, (out - ref).abs().max().item())
        torch.cuda.empty_cache()

        iters = 5
        kern(), plain()
        p1, k1, k2, p2 = (time_ms(plain, iters), time_ms(kern, iters),
                          time_ms(kern, iters), time_ms(plain, iters))
        flops = 2 * field_macs(cfg, density_only=not with_dirs) * n_pts
        nbytes = n_pts * (ff.IN_COLS + n_cols) * 4 + weight_bytes
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        report.append({
            "name": name, "route": "cuda", "source": K1_BF16_SOURCE,
            "replaces": K1_SOURCE,
            "launches": None, "max_abs_err": max_abs,
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        emit("kernel", name=name, points=n_pts, flops=flops, bytes=nbytes, slabs=n_slabs,
             rel_err_by_points=errs, rel_err_vs_k2_by_points=errs_k2,
             rel_bound=TRAIN_KERNEL_REL, max_abs_err=max_abs, rerun_identical=True,
             ms=[k1, k2], plain_ms=[p1, p2], bound_ops_ms=t_ops, bound_bytes_ms=t_bytes,
             tflops=flops / ((k1 + k2) / 2) / 1e9, **occupancy,
             ptxas=ptxas.get("full" if with_dirs else "density", "not built in this run"),
             stage_ms=stage_ms(kern, "k1_bf16_"),
             other_head_counts_rel_err=k1_bf16_head_counts(cfg, gen, with_dirs))
    return report


def train_field_flops(cfg: FieldConfig) -> tuple[int, int]:
    """FLOPs per point of K2 and of K3 (twice the multiply-adds). K3 runs
    the transposed products of every layer but the ones fed by the
    embedding (x gets no gradient), every weight product act^T @ delta,
    and recomputes the coarse features vf."""
    w, half, k = cfg.width, cfg.width // 2, cfg.coarse_radiance_number
    fwd = field_macs(cfg, density_only=False)
    bwd = (2 * fwd - 2 * cfg.input_ch * w - cfg.input_ch_views * w
           + w * k * half)
    return 2 * fwd, 2 * bwd


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def field_grad_errors(cfg, params, gen, n_rays, n_samples) -> dict:
    """Gradients of one loss on the field's raw output into the field
    params, on the same points and target: the gradient-path query on
    K2/K3 and the eager bf16 query, each against the eager f32 query
    (relative norm) -- the training step's three paths, at one shape."""
    leaves = _leaves(params)
    pts = torch.rand((n_rays, n_samples, 3), device="cuda", generator=gen) * 4 - 2
    dirs = torch.nn.functional.normalize(
        torch.randn((n_rays, 3), device="cuda", generator=gen), dim=-1)
    tgt = torch.randn((n_rays, n_samples, 9 + 3 * cfg.coarse_radiance_number),
                      device="cuda", generator=gen)
    grads = {}
    for name, kw in (("kernels", {}), ("eager_bf16", dict(use_pallas_train=False)),
                     ("eager_f32", dict(use_pallas_train=False, compute_dtype="float32"))):
        rcfg = train_config(cfg, use_pallas=False, **kw)[0]
        query_full = renderer._make_queries(params, rcfg)[0]
        loss = ((query_full(pts, dirs) - tgt) ** 2).mean()
        grads[name] = flat_grads(torch.autograd.grad(loss, leaves))
    ref = grads["eager_f32"]
    return {k: ((grads[k] - ref).norm() / ref.norm()).item() for k in ("kernels", "eager_bf16")}


def k3_design_floor(w16: dict, n: int) -> dict:
    """The least time K3's two-stage design could take on n points: the
    bytes of its own traffic in device memory over the memory rate. The
    chain reads x, g, hv and the 9 mask planes and writes the 15 delta
    planes; the dW stage reads each product's activation and delta planes
    once, and g for the output bias."""
    shapes = {k: tuple(v.shape) for k, v in w16.items()}
    cols = fft.plane_cols(shapes)
    n_out, width = shapes["bias"][0], shapes["w1"][0]
    chain = (ff.IN_COLS * 4 + n_out * 4 + 10 * width * 2
             + sum(cols[k] for k in fft._DELTA_ORDER) * 2)
    dw = sum(cols[a] + cols[dl] for _, a, dl in fft._DW_PRODUCTS) * 2 + n_out * 4
    ms = {k: n * b / PEAK_BYTES * 1e3 for k, b in (("chain", chain), ("dw", dw))}
    return {**ms, "both": ms["chain"] + ms["dw"], "bytes_per_point": chain + dw}


def k2_design_floor(w16: dict, n: int) -> dict:
    """The least time K2's design could take on n points: the bytes of its
    own traffic in device memory over the memory rate. The pack reads each
    weight once and writes the slab stream; the forward reads x and the
    stream once (later tiles find it in L2) and writes raw and the 11
    residual planes."""
    _, n_slabs = fft.forward_schedule(fft._shapes(w16))
    stream = n_slabs * fft.SLAB_N * fft.SLAB_K * 2
    n_out, width = w16["bias"].shape[0], w16["w1"].shape[0]
    pack = sum(v.numel() * 2 for v in w16.values()) + stream
    fwd = n * (ff.IN_COLS * 4 + n_out * 4 + len(fft._RES_ORDER) * width * 2) + stream
    ms = {k: b / PEAK_BYTES * 1e3 for k, b in (("pack", pack), ("forward", fwd))}
    return {**ms, "both": ms["pack"] + ms["forward"], "bytes": pack + fwd}


def train_kernel_phase(cfg, field_params, gen) -> list[dict]:
    """K2 and K3 against their plain versions at the fine-pass (512x192)
    and coarse-pass (512x64) point counts and at ragged ones (1 and 63
    points: fewer pipeline stages than the ring holds; 4,097: a point
    range of one stage), each rerun for bit-equality, and their gradients
    against the eager paths'; timed at the fine-pass shape and by stage."""
    w16 = fft.to_bf16(ff.pack_field_weights(field_params, cfg))
    emb = fft.emb_constants(cfg, torch.device("cuda"))
    n_out = 9 + 3 * cfg.coarse_radiance_number
    fine, coarse = 512 * (64 + 128), 512 * 64
    errs = {"fwd": {}, "bwd": {}}
    for n in (1, 63, 4097, fine + 37, coarse, fine):
        pts = torch.rand((n, 1, 3), device="cuda", generator=gen) * 4 - 2
        dirs = torch.nn.functional.normalize(
            torch.randn((n, 3), device="cuda", generator=gen), dim=-1)
        x = ff._pack_inputs(pts, dirs)
        g = torch.randn((n, n_out), device="cuda", generator=gen) * 1e-3
        raw, res = fft._launch_fwd(x, w16, emb)
        raw_again, res_again = fft._launch_fwd(x, w16, emb)
        raw_p, res_p = fft.train_forward_plain(x, w16, emb)
        dw = fft._launch_bwd(x, g, res_p, w16, emb)
        dw_again = fft._launch_bwd(x, g, res_p, w16, emb)
        dw_p = fft.train_backward_plain(x, g, res_p, w16, emb)
        torch.cuda.synchronize()
        fwd = {"raw": rel_err(raw, raw_p)}
        fwd.update({k: rel_err(res[i], res_p[i]) for i, k in enumerate(fft._RES_ORDER)})
        bwd = {k: rel_err(dw[k], dw_p[k]) for k in fft._DW_ORDER}
        if not torch.isfinite(raw).all() or not all(torch.isfinite(v).all() for v in dw.values()):
            fail("kernel", f"K2/K3: non-finite output at {n} points")
        if not (torch.equal(raw, raw_again) and torch.equal(res, res_again)):
            fail("kernel", f"K2: two runs on the same inputs differ at {n} points")
        if not all(torch.equal(dw[k], dw_again[k]) for k in fft._DW_ORDER):
            fail("kernel", f"K3: two runs on the same inputs differ at {n} points")
        for name, e in (("K2", fwd), ("K3", bwd)):
            worst = max(e, key=e.get)
            if not e[worst] <= TRAIN_KERNEL_REL:
                fail("kernel", f"{name} at {n} points: block {worst} off by "
                     f"{e[worst]:.3e} relative (bound {TRAIN_KERNEL_REL})")
        errs["fwd"][n], errs["bwd"][n] = fwd, bwd
        max_abs = {"fwd": (raw - raw_p).abs().max().item(),
                   "bwd": max((dw[k] - dw_p[k]).abs().max().item() for k in dw)}

    grad_err = field_grad_errors(cfg, field_params, gen, 512, 64 + 128)
    if not grad_err["kernels"] <= GRAD_RATIO * grad_err["eager_bf16"]:
        fail("kernel", f"K2/K3 field gradient error {grad_err['kernels']:.3e} exceeds "
             f"{GRAD_RATIO} x the eager bf16 field's {grad_err['eager_bf16']:.3e}")
    emit("kernel", name="fused_field_train_grad", points=fine,
         grad_rel_err_vs_f32=grad_err, ratio_bound=GRAD_RATIO)

    # timing at the fine-pass shape, in turns: plain, kernel, kernel, plain
    iters = 5
    f_flops, b_flops = (f * fine for f in train_field_flops(cfg))
    weight_bytes = sum(v.numel() * 2 for v in w16.values())
    io_bytes = fine * (ff.IN_COLS * 4 + n_out * 4 + len(fft._RES_ORDER) * cfg.width * 2)
    dw_bytes = sum(v.numel() * 4 for v in w16.values())
    cases = [
        ("fused_field_train_fwd", "ibl_nerf_tpu/kernels/fused_field_train.py:110",
         lambda: fft._launch_fwd(x, w16, emb),
         lambda: fft.train_forward_plain(x, w16, emb),
         f_flops, io_bytes + weight_bytes),
        ("fused_field_train_bwd", "ibl_nerf_tpu/kernels/fused_field_train.py:143",
         lambda: fft._launch_bwd(x, g, res_p, w16, emb),
         lambda: fft.train_backward_plain(x, g, res_p, w16, emb),
         b_flops, io_bytes + weight_bytes + dw_bytes),
    ]
    report = []
    for (name, replaces, kern, plain, flops, nbytes), which in zip(cases, ("fwd", "bwd")):
        kern(), plain()
        p1, k1, k2, p2 = (time_ms(plain, iters), time_ms(kern, iters),
                          time_ms(kern, iters), time_ms(plain, iters))
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        worst = {n: max(e.values()) for n, e in errs[which].items()}
        stages = stage_ms(kern, "k2_" if which == "fwd" else "k3_")
        floor = (k2_design_floor if which == "fwd" else k3_design_floor)(w16, fine)
        report.append({
            "name": name, "route": "cuda",
            "source": "ibl_nerf_tpu_torch/csrc/fused_field_train.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max_abs[which],
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        emit("kernel", name=name, points=fine, flops=flops, bytes=nbytes,
             worst_rel_err_by_points=worst, rel_err_fine=errs[which][fine],
             rel_bound=TRAIN_KERNEL_REL, max_abs_err_fine=max_abs[which],
             ms=[k1, k2], plain_ms=[p1, p2], bound_ops_ms=t_ops,
             bound_bytes_ms=t_bytes, design_floor_ms=floor,
             tflops=flops / ((k1 + k2) / 2) / 1e9, stage_ms=stages)
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


def serving_config(cfg: FieldConfig, **kw) -> RenderConfig:
    """scripts/infer_bench.py's serving configuration at chunk 2048."""
    return RenderConfig(
        field=cfg, n_samples=64, n_importance=128, perturb=False,
        approximate_radiance=True,
        normal_type="normal_map_from_depth_gradient_epsilon",
        correct_depth_for_prefiltered_radiance_infer=True,
        compute_dtype="bf16_grad", use_pallas=True, coarse_shading=False).replace(**kw)


def first_chunk(scene) -> dict:
    """The first 2048 rays of pose 0."""
    K = torch.tensor([[scene.focal, 0, 0.5 * W], [0, scene.focal, 0.5 * H],
                      [0, 0, 1]], dtype=torch.float32, device="cuda")
    ro, rd = get_rays_full_image(H, W, K, torch.from_numpy(scene.poses[0]).cuda())
    return make_ray_batch(ro.reshape(-1, 3)[:CHUNK], rd.reshape(-1, 3)[:CHUNK],
                          scene.near, scene.far)


def chunk_ms_events(variables, consts, batch, rcfg) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    render_rays(variables, consts, batch, rcfg)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def serve(phase: str, variables, consts, scene, rcfg, kernels, expect: dict) -> dict:
    """The main serving path: `render_path` over the scene with every
    launch count zeroed just before it. Fails unless each count in
    `expect` (per chunk; the rest 0) was reached and every buffer is
    finite; the kernel rows named in `expect` take their counts."""
    counters = (ff.LAUNCHES, fft.LAUNCHES)
    for c in counters:
        for k in c:
            c[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = render_path(variables, consts, scene, rcfg, chunk=CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.items()}

    n_chunks = N_POSES * -(-(H * W) // CHUNK)
    for name, count in launches.items():
        if count != expect.get(name, 0) * n_chunks:
            fail(phase, f"{name} launched {count} times, expected "
                 f"{expect.get(name, 0) * n_chunks} ({expect.get(name, 0)} per chunk, "
                 f"{n_chunks} chunks)")
    for row in kernels:
        if row["name"] in expect:
            row["launches"] = launches[row["name"]]
    for k, v in results.items():
        if v.shape[:3] != (N_POSES, H, W) or not np.isfinite(v).all():
            fail(phase, f"buffer {k}: shape {v.shape} or non-finite values")
    for k in ("rgb", "target_normal_map", "reflected_radiance", "depth", "acc"):
        if k not in results:
            fail(phase, f"buffer {k} missing")
    k1_ms = sum(r["ms"] for r in kernels if r["name"] in expect)
    return dict(poses=N_POSES, height=H, width=W, chunk=CHUNK, chunks=n_chunks,
                seconds=seconds, rays_per_s=N_POSES * H * W / seconds,
                ms_per_chunk=seconds / n_chunks * 1e3,
                k1_ms_per_chunk_from_kernel_phase=k1_ms, launches=launches,
                buffers=sorted(results))


def slice_phase(cfg, variables, consts, kernels, card: str) -> None:
    """Serving under bf16_grad: K1 at f32 weights on the no-grad sweeps."""
    rcfg = serving_config(cfg)
    scene = Scene()

    # one chunk of pose 0: K1 against the eager path (also the warm-up)
    batch = first_chunk(scene)
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
    events_ms = chunk_ms_events(variables, consts, batch, rcfg)

    served = serve("slice", variables, consts, scene, rcfg, kernels,
                   {"fused_field_density": 1, "fused_field_apply": 1})
    emit("slice", card=card, compute_dtype=rcfg.compute_dtype, **served,
         chunk_ms_cuda_events=events_ms, chunk_vs_eager_max_abs_err=chunk_err,
         atol=SLICE_ATOL, rtol=SLICE_RTOL)


def slice_bf16_phase(cfg, variables, consts, kernels, card: str) -> None:
    """Serving under compute_dtype bfloat16 (scripts/infer_bench.py's
    frame:2048:bf16): every query bf16, K1's bf16-weight variant on the
    no-grad sweeps. One chunk is held against the f32 render of the same
    chunk, as tests/test_dtypes.py holds the bf16 modes."""
    rcfg = serving_config(cfg, compute_dtype="bfloat16")
    scene = Scene()
    batch = first_chunk(scene)
    out = render_rays(variables, consts, batch, rcfg)
    ref = render_rays(variables, consts, batch,
                      rcfg.replace(compute_dtype="float32", use_pallas=False))
    chunk_err = {}
    for k in BF16_MAPS:
        chunk_err[k] = (out[k] - ref[k]).abs().max().item()
        if not torch.isfinite(out[k]).all() or not chunk_err[k] <= BF16_ATOL:
            fail("slice_bf16", f"{k}: the bf16 render is {chunk_err[k]:.3e} from the "
                 f"f32 render (bound {BF16_ATOL})")
    events_ms = chunk_ms_events(variables, consts, batch, rcfg)

    served = serve("slice_bf16", variables, consts, scene, rcfg, kernels,
                   {"fused_field_density_bf16": 1, "fused_field_apply_bf16": 1})
    emit("slice_bf16", card=card, compute_dtype=rcfg.compute_dtype, **served,
         chunk_ms_cuda_events=events_ms, chunk_vs_f32_max_abs_err=chunk_err,
         atol=BF16_ATOL)


def train_config(cfg: FieldConfig, **kw):
    rcfg = RenderConfig(
        field=cfg, n_samples=64, n_importance=128, perturb=True,
        normal_type="normal_map_from_sigma_gradient_surface",
        correct_depth_for_prefiltered_radiance_infer=True,
        compute_dtype="bf16_grad", use_pallas_train=True, use_pallas=True).replace(**kw)
    lcfg = LossConfig(load_priors=True, freeze_roughness=True,
                      n_iter_ignore_approximated_radiance=10000,
                      n_iter_ignore_prior=100000, beta_prior_albedo=1.0,
                      beta_irradiance_reg=0.1, coarse_radiance_number=3)
    return rcfg, lcfg, resolve_phase(50000, lcfg)


def train_scene(device, gen, h=TRAIN_H, w=TRAIN_W, n_img=TRAIN_IMAGES) -> dict:
    """bench.py's synthetic scene, made on the device from a seed: uniform
    images and K=3 prefiltered stacks, poses stepping along z."""
    poses = torch.eye(4, device=device).repeat(n_img, 1, 1)
    poses[:, 2, 3] = torch.linspace(0, 1, n_img, device=device)
    return {
        "images": torch.rand((n_img, h, w, 3), device=device, generator=gen),
        "prefiltered_images": torch.rand((3, n_img, h, w, 3), device=device,
                                         generator=gen),
        "poses": poses,
        "K": torch.tensor([[555.0, 0, w / 2], [0, 555.0, h / 2], [0, 0, 1]],
                          device=device),
    }


def flat_grads(grads) -> torch.Tensor:
    return torch.cat([g.reshape(-1).float() for g in _leaves(grads)])


# Kernel names of the port's own CUDA kernels, by the row they belong to.
OWN_KERNELS = {"fused_field_kernel": "K1", "k1_bf16_": "K1-bf16", "k2_": "K2", "k3_": "K3"}


def profile_steps(step, state, arrays, gen, n=2) -> dict:
    """Kernel time on the device over n train steps (torch.profiler), the
    share of K1/K2/K3 in it, and the device's busy share of the profiled
    host-clock window (the profiler slows the host). Empty when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, arrays, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, launches, host_waits = {}, 0, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            # operator rows repeat the time of the kernels they launch; count
            # the runtime calls that make the host wait for the device
            if "Synchronize" in ev.key or ev.key == "cudaMemcpy":
                host_waits += ev.count
            continue
        launches += ev.count
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / n
    device_ms = sum(by_name.values())
    if device_ms == 0:
        return {}
    own = {}
    for name, ms in by_name.items():
        for prefix, row in OWN_KERNELS.items():
            if prefix in name:
                own[row] = own.get(row, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": n, "wall_ms_per_step": wall_ms / n, "device_ms_per_step": device_ms,
            "device_ops_per_step": launches / n, "host_waits_per_step": host_waits / n,
            "busy_share": device_ms / (wall_ms / n), "own_ms_per_step": own,
            "own_share_of_device": sum(own.values()) / device_ms,
            "top_kernels_ms_per_step": dict(top)}


# The renderer's functions whose results `held_inputs` holds fixed.
HELD = [(renderer, "sample_pdf"), (normals_mod, "normal_from_sigma_gradient_surface")]


@contextlib.contextmanager
def held_inputs(saved: list, deviation: dict | None = None):
    """Within the block, the renderer's importance samples and sgs normals
    are recorded into `saved` in call order; with `deviation` given, they
    are instead taken from `saved` in that order, and the mean absolute
    difference of each value the path computed itself from the one it
    was given is appended to `deviation[name]`."""
    originals = {(mod, name): getattr(mod, name) for mod, name in HELD}
    taken = iter(saved)

    def wrap(fn, name):
        def held(*args, **kwargs):
            own = fn(*args, **kwargs)
            if deviation is None:
                saved.append(own)
                return own
            given = next(taken, None)
            if given is None:
                raise RuntimeError("held_inputs: a path asked for more held values "
                                   "than were saved")
            deviation.setdefault(name, []).append((own - given).abs().mean().item())
            return given
        return held

    for (mod, name), fn in originals.items():
        setattr(mod, name, wrap(fn, name))
    try:
        yield
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    if deviation is not None and next(taken, None) is not None:
        raise RuntimeError("held_inputs: a path used fewer held values than were saved")


def step_grad_errors(paths: dict, state, arrays, gen, hold: bool) -> dict:
    """Relative gradient errors against the "eager_f32" path of one step
    from `state`, over GRAD_DRAWS draws shared by all paths. With `hold`,
    every path takes the f32 path's importance samples and sgs normals,
    and the mean absolute difference of its own from them is reported."""
    errs = {k: [] for k in paths if k != "eager_f32"}
    dev = {k: {} for k in errs}
    for _ in range(GRAD_DRAWS):
        draws = paths["eager_f32"].draw(arrays, gen)
        saved = []
        with held_inputs(saved) if hold else contextlib.nullcontext():
            ref = flat_grads(paths["eager_f32"].loss_and_grads(state.variables, arrays, draws)[2])
        for k in errs:
            with held_inputs(saved, dev[k]) if hold else contextlib.nullcontext():
                g = flat_grads(paths[k].loss_and_grads(state.variables, arrays, draws)[2])
            errs[k].append(((g - ref).norm() / ref.norm()).item())
    return {"per_draw": errs, "held_input_deviation_mean": (
        {k: {name: float(np.mean(v)) for name, v in d.items()} for k, d in dev.items()}
        if hold else None)}


def host_us_per_op(n: int = 2000) -> float:
    """Host microseconds to launch one tiny CUDA operation: the cost that
    bounds a step made of ~1,600 of them."""
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def train_phase(cfg, variables, consts, kernels, card: str) -> dict:
    """The training slice: warm-up steps; from their state, the gradients
    of the kernel path and of the eager bf16 path against an f32 eager
    step; then timed windows with the launch counts zeroed before them,
    and a profiler breakdown."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    arrays = train_scene("cuda", gen)
    rcfg, lcfg, phase = train_config(cfg)
    optimizer = build_optimizer(variables, lrate=5e-4, lrate_decay=500, lcfg=lcfg)
    state = init_train_state(variables, optimizer)

    def make(rc):
        return make_train_step(rc, lcfg, phase, optimizer, consts, TRAIN_H, TRAIN_W,
                               N_RAND, prior_irradiance_mean=0.7, near=2.0, far=8.0)

    step = make(rcfg)
    for _ in range(WARMUP_STEPS):
        state, scalars = step(state, arrays, generator=gen)
    torch.cuda.synchronize()

    # gradients of one step from the same state and draws, three ways
    paths = {"eager_f32": make(rcfg.replace(use_pallas_train=False, use_pallas=False,
                                            compute_dtype="float32")),
             "kernels": step,
             "eager_bf16": make(rcfg.replace(use_pallas_train=False, use_pallas=False))}
    held = step_grad_errors(paths, state, arrays, gen, hold=True)
    err = {k: float(np.mean(v)) for k, v in held["per_draw"].items()}
    if not err["kernels"] <= GRAD_RATIO * err["eager_bf16"]:
        fail("train", f"kernel-path gradient error {err['kernels']:.3e} (mean of "
             f"{GRAD_DRAWS} draws) exceeds {GRAD_RATIO} x the eager bf16 path's "
             f"{err['eager_bf16']:.3e}")
    free = step_grad_errors(paths, state, arrays, gen, hold=False)

    counters = (ff.LAUNCHES, fft.LAUNCHES)
    for c in counters:
        for k in c:
            c[k] = 0
    torch.cuda.reset_peak_memory_stats()
    windows = []
    for _ in range(WINDOWS):
        host_op = host_us_per_op()
        t0 = time.perf_counter()
        for _ in range(WINDOW_STEPS):
            state, scalars = step(state, arrays, generator=gen)
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        windows.append({"ms_per_step": seconds / WINDOW_STEPS * 1e3,
                        "host_issue_ms_per_step": issued / WINDOW_STEPS * 1e3,
                        "host_us_per_op": host_op})
    launches = {**ff.LAUNCHES, **fft.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    steps = WINDOWS * WINDOW_STEPS
    seconds = sum(w["ms_per_step"] for w in windows) * WINDOW_STEPS / 1e3

    want = {"fused_field_train_fwd": 2 * steps, "fused_field_train_bwd": 2 * steps,
            "fused_field_apply": 2 * steps}
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail("train", f"{k} launched {n} times in {steps} steps, "
                 f"expected {want.get(k, 0)}")
    for row in kernels:
        if row["name"] in fft.LAUNCHES:
            row["launches"] = launches[row["name"]]
    loss = float(scalars["loss_total"])
    if not np.isfinite(loss) or not all(torch.isfinite(p).all()
                                        for p in _leaves(state.variables)):
        fail("train", f"loss {loss} or a param is not finite after {steps} steps")

    report = dict(card=card, rays=N_RAND, steps=steps, seconds=seconds,
                  ms_per_step=seconds / steps * 1e3, rays_per_s=N_RAND * steps / seconds,
                  windows=windows, cpus_usable=len(os.sched_getaffinity(0)),
                  loadavg=os.getloadavg(), launches=launches, loss=loss,
                  grad_check={"held": "importance samples and sgs normals of the f32 path",
                              "rel_err_vs_f32_mean": err, **held,
                              "ratio": err["kernels"] / err["eager_bf16"],
                              "ratio_bound": GRAD_RATIO},
                  grad_rel_err_free_per_draw=free["per_draw"],
                  peak_memory_bytes=peak,
                  profile=profile_steps(step, state, arrays, gen))
    emit("train", **report)
    return report


def train_mixed_phase(cfg, consts, card: str) -> dict:
    """scripts/perf_sweep.py's mixed:pallas training step, small: 512
    rays, ε-normals, compute_dtype mixed (the gradient path eager f32, the
    no-grad sweeps bf16), K1's bf16-weight variant on the ε sweep and the
    reflected march of both passes, no K2/K3. Warm-up steps, then timed
    steps with every launch count zeroed before them, and a profiler
    breakdown."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    arrays = train_scene("cuda", gen)
    rcfg, lcfg, phase = train_config(
        cfg, compute_dtype="mixed", use_pallas_train=False,
        normal_type="normal_map_from_depth_gradient_epsilon")
    rng = np.random.default_rng(SEED + 1)
    variables = {"coarse": init_field_params(rng, cfg, "cuda"),
                 "fine": init_field_params(rng, cfg, "cuda")}
    for v in _leaves(variables):
        v.requires_grad_(True)
    optimizer = build_optimizer(variables, lrate=5e-4, lrate_decay=500, lcfg=lcfg)
    state = init_train_state(variables, optimizer)
    step = make_train_step(rcfg, lcfg, phase, optimizer, consts, TRAIN_H, TRAIN_W,
                           N_RAND, prior_irradiance_mean=0.7, near=2.0, far=8.0)
    for _ in range(WARMUP_STEPS):
        state, scalars = step(state, arrays, generator=gen)
    torch.cuda.synchronize()

    counters = (ff.LAUNCHES, fft.LAUNCHES)
    for c in counters:
        for k in c:
            c[k] = 0
    t0 = time.perf_counter()
    for _ in range(MIXED_STEPS):
        state, scalars = step(state, arrays, generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.items()}

    want = {"fused_field_density_bf16": 2 * MIXED_STEPS,
            "fused_field_apply_bf16": 2 * MIXED_STEPS}
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail("train_mixed", f"{k} launched {n} times in {MIXED_STEPS} steps, "
                 f"expected {want.get(k, 0)}")
    loss = float(scalars["loss_total"])
    leaves = _leaves(state.variables)
    if not np.isfinite(loss) or not all(torch.isfinite(p).all() for p in leaves):
        fail("train_mixed", f"loss {loss} or a param is not finite after "
             f"{WARMUP_STEPS + MIXED_STEPS} steps")
    if any(p.dtype != torch.float32 for p in leaves):
        fail("train_mixed", "a master param left f32")
    report = dict(card=card, compute_dtype=rcfg.compute_dtype, rays=N_RAND,
                  steps=MIXED_STEPS, seconds=seconds,
                  ms_per_step=seconds / MIXED_STEPS * 1e3,
                  rays_per_s=N_RAND * MIXED_STEPS / seconds, launches=launches, loss=loss,
                  profile=profile_steps(step, state, arrays, gen))
    emit("train_mixed", **report)
    return report


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
                     if "entry function" in ln or "registers" in ln or "spill" in ln]
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
    kernels += k1_bf16_kernel_phase(cfg, variables["fine"], gen)
    train_vars = {"coarse": init_field_params(rng, cfg, device),
                  "fine": init_field_params(rng, cfg, device)}
    for v in _leaves(train_vars):
        v.requires_grad_(True)
    kernels += train_kernel_phase(cfg, train_vars["fine"], gen)
    slice_phase(cfg, variables, consts, kernels, card)
    slice_bf16_phase(cfg, variables, consts, kernels, card)
    train_phase(cfg, train_vars, consts, kernels, card)
    del train_vars
    torch.cuda.empty_cache()
    train_mixed_phase(cfg, consts, card)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
