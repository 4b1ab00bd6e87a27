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
          least 2 for f32) and ptxas registers and spills; K1 density at
          f32 with no spill store, also at a 4096-ray update's two ε
          sweeps (1,048,576 and 3,145,728 points), within 2e-7 relative
          norm of its plain version at each of its three shapes and
          timed in turns with it; K1 full at f32
          also at the train step's 512 x 64 points and with 0, 1 and 2
          coarse heads; its head sets as rows of their own, "incident" at
          the Monte-Carlo incident march of a chunk (18,432 rays x 64
          samples, a view direction per ray) and "reflected" at the
          reflected march of a chunk and of the CLI's 4096-ray update,
          each kept column bit-equal to K1 full's, a rerun bit-identical,
          timed in turns with K1 full at the same points; K1 at bf16
          weights also against K2's raw;
          K1 at f64 weights, `fused_field_*_f64`, within 1e-7 (full) and
          2e-7 (density) relative norm of its plain version, also at
          K = 0, 1 and 4, two runs bit-identical, the outputs not
          bit-equal to it counted; full also timed and held at the
          Monte-Carlo march's shape; its shared memory per block equal
          to kernels/fused_field_f64.smem_bytes at every K), K2
          (raw and the 11 residuals; also at the benchmark cells' shapes,
          and its variant without residual stores, whose raw must equal
          K2's bit for bit) and K3 (the 24 weight gradients; also fed the
          kernel K2's residuals, against the plain backward of the plain
          forward), the bf16 ones each with two runs bit-identical;
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
  train_cli  `python -m ibl_nerf_tpu_torch.cli.train` through its `main`,
          on a Mitsuba scene this script writes with the port's PNG
          encoder (8 train images at 480x640 with their gt normals and
          albedo, 2 test images with normals, albedo and irradiance):
          --use_pallas --use_pallas_train and the CLI's defaults
          otherwise (ground-truth normals, merged sampling, 4096 rays,
          bf16_grad) at 8x256, K=3, 64+128 samples; 31 updates with the
          phase switch at 10, a checkpoint and a test-set render (PNGs) at
          update 30, then a resume to update 35. Gates: finite losses, 2
          K2 and 2 K3 launches in every step, 2 K1 full launches per step
          past the switch and none before, no K1 density launch anywhere,
          one K1 full and one K2 launch (without residual stores) per
          2048-ray chunk of the render and none with them (the fine pass's
          primary march runs the gradient-path query), the resume
          starting at update 31, every PNG decoding at 480x640. Prints the
          scene's decode and pyramid times, ms per step and train rays/s
          (each step synchronised), the render's time and peak memory.
  eval_cli  on train_cli's newest checkpoint (ckpt_000030) and scene,
          through the CLIs' `main`s with --use_pallas --use_pallas_train
          and the defaults otherwise: `cli.test` at 480x640 with
          --extract_mesh (one K1 full and one K2 launch without residual
          stores per 2048-ray chunk, none with them, no K1 density; 20
          or more PNGs decoding at 480x640; the rgb's psnr and ssim
          against the test image, the mesh's grid and marching-cubes
          seconds and vertex count); an edit (albedo
          and roughness constants on object 1) and an insert into test
          frame 1, each equal bit for bit to the plain render outside
          the mask and to its targets inside; normal_map_from_depth_
          gradient at render factor 4 (unit-norm, finite normals); and
          `cli.render` over a 3-frame orbit at render factor 2 (ε normals:
          one K1 density launch per chunk besides K1 full and K2; its
          rgb.avi, parsed here, holds the rgb stack). Prints the seconds
          per 480x640 image, of the edit and the insert, per orbit frame
          and of the mesh.
  tools   the eval/utils layer on eval_cli's outputs: compare.calculate_
          metrics on the card equal (within 1e-6) to batch_metrics on the
          same decoded PNG pairs, its CSV and LaTeX rows, the train run's
          time row; visualize_comparison (1 page) and comparison_report
          (2 pages) with one embedded image per existing tile, the first
          equal to its PNG; profile_trace around cli.test at render
          factor 16 (one chunk per rendered test image): one K1 full and
          one K2 launch (without residual stores) a chunk, and the
          trace's kernel events name fused_field_kernel and k2_forward as often; the orbit's frames
          as .mp4 and, cycled to 5,000 frames, as an OpenDML AVI of two
          or more RIFFs, both read back frame for frame; the 30-update
          fine field's 48^3 density grid on the card against the CPU's
          (rtol 1e-3, atol 5e-4) and a non-empty mesh at its 90th
          percentile. Prints each step's seconds and the files' sizes.
  aux_cli  the aux heads and Monte-Carlo shading through the CLIs' `main`s
          on train_cli's scene: `cli.train` with every aux head
          (--infer_normal --infer_depth --infer_{albedo,roughness,
          irradiance}_separate --infer_visibility --use_environment_map)
          at 1024 rays, train_cli's flags otherwise, the normal, depth and
          shading losses from update 10, 21 updates and a checkpoint at 20.
          Gates: finite losses; the inferred-normal and depth losses 0
          before update 10 and above 0 from it; the five trained heads
          unchanged before update 10 and moved after it, the visibility
          head and the environment map never moved; 2 K2 and 2 K3 launches
          an update, 2 K1 full from the switch on, no K1 density. Then a
          resume to update 24 under --shading_mode monte_carlo: finite
          losses, 2 K1 full launches an update (the incident march of the
          coarse and the fine pass), each at 1024 x 9 rays x 64 samples.
          Then `cli.test` on ckpt_000020 with the same heads, Monte-Carlo
          shading and --calculating_normal_type inferred_normal_map at
          render factor 2 (38 chunks): one K2 (without residual stores)
          and one K1 full launch (at 2048 x 9 x 64 points) per chunk and
          nothing else, every buffer finite, the inferred_normal_map and
          inferred_disp PNGs written.
          Prints ms per update before and after the switch and under
          Monte-Carlo shading, peak memory, cli.test's seconds per image,
          and a profiler breakdown of update 20 and of a second cli.test
          call.
  flags_dp  the trainer's last flags and data parallelism on train_cli's
          scene, through `cli.train.main` with train_cli's flags and
          --ray_sample patch --no_batching --raw_noise_std 1.0
          --init_port_path (a reference-layout .tar this script writes)
          --mesh_devices 2 at 4096 rays: 2 updates from an init whose fine
          σ bias is -100 (it arrives bit for bit, is logged as dead and
          stays below -99: never re-drawn), then 16 from a live init
          (finite losses, patch_depth_smoothness above 0, 2 K2 and 2 K3
          an update and 2 K1 full from the switch, the clamp of
          --mesh_devices 2 to this card logged; ms per update). Then
          make_sharded_train_step over two shards of cuda:0 against the
          unsharded step on the same draws for 3 updates (the loss within
          1e-4 and each group's move within 1e-2 relative). Then
          `--num_processes 2` in two worker processes of this script on
          the one card over gloo, and a 1-rank NCCL group: the replicas
          bit-identical, only rank 0 writing the logdir, the last
          checkpoint restoring the final params; each update and its
          all_reduce timed. Each leg's processes have a 300 s timeout.
  f64     compute_dtype float64 with --use_pallas: the serving path as in
          slice (one K1-f64 density and one K1-f64 full launch per chunk,
          no other kernel), one chunk within the f32 bounds (atol/rtol
          5e-4/1e-3 basic, 2e-3/5e-3 shaded) of the eager f64 render, its
          gap printed; `cli.train` on train_cli's scene at 1024 rays for
          12 updates across the phase switch at 10 (finite losses, 2 K1-f64
          full launches an update from the switch and none before, nothing
          else; peak memory); `cli.test` on its last checkpoint at render
          factor 4 (one K1-f64 full launch per chunk and nothing else).
Weights are random from a seed. Then the per-kernel JSON line, the card
line, and the ok line last. Every number printed is measured in this
run, on this card.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ibl_nerf_tpu_torch.cli import render as cli_render
from ibl_nerf_tpu_torch.cli import test as cli_test
from ibl_nerf_tpu_torch.cli import train as cli_train
from ibl_nerf_tpu_torch.cli.config import parse_with_includes
from ibl_nerf_tpu_torch.data import dataset as dataset_mod
from ibl_nerf_tpu_torch.data import native_loader
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.eval import compare, visualize
from ibl_nerf_tpu_torch.eval.metrics import batch_metrics
from ibl_nerf_tpu_torch.eval.render_path import render_path
from ibl_nerf_tpu_torch.kernels import build as kernel_build
from ibl_nerf_tpu_torch.kernels import fused_field as ff
from ibl_nerf_tpu_torch.kernels import fused_field_bf16 as k1b
from ibl_nerf_tpu_torch.kernels import fused_field_f64 as k1d
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
from ibl_nerf_tpu_torch.parallel.mesh import make_sharded_train_step
from ibl_nerf_tpu_torch.train import checkpoint as ckpt_lib
from ibl_nerf_tpu_torch.train import loop as loop_mod
from ibl_nerf_tpu_torch.train.step import TrainState, _leaves
from ibl_nerf_tpu_torch.utils.logging import load_logger
from ibl_nerf_tpu_torch.utils.device import resolve_device
from ibl_nerf_tpu_torch.utils import mesh_extract, timing
from ibl_nerf_tpu_torch.utils import video as video_mod
from ibl_nerf_tpu_torch.utils.png import write_png

# H100 SXM data-sheet rates at the full 700 W: f32 outside the tensor
# cores, bf16 and f64 on the tensor cores (dense), and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_F64_FLOPS = 67e12
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
# K1 at f64 weights against its plain version, per output in relative
# norm (full, density): both round every product to f32 at the same
# points and differ only in the order of the f64 sums (mma.sync against
# cuBLAS), which flips an f32 rounding rarely; the bounds of
# tests/test_torch_fused_field_f64.py, which the same math on f32 operands
# fails.
K1_F64_REL = {True: 1e-7, False: 2e-7}

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
# The train_cli phase: the training CLI on a scene written under the
# checkout's git-ignored build/ (Kitchen's 480x640, 8 train images).
CLI_DIR = Path(__file__).resolve().parent / "build" / "smoke_cli"
CLI_TRAIN_IMAGES, CLI_TEST_IMAGES = 8, 2
CLI_RAYS, CLI_CHUNK = 4096, 2048
CLI_SWITCH, CLI_N_ITER, CLI_RESUME_N_ITER = 10, 30, 35
CLI_PROFILED = 20  # the update whose step runs under torch.profiler
# The eval_cli phase: the test and render CLIs on train_cli's newest
# checkpoint and scene. Test frame 1 holds one object, a rectangle at gray
# 10/255, in its edit and insert masks.
EVAL_MASK = (slice(120, 300), slice(200, 440))
EVAL_ALBEDO, EVAL_ROUGHNESS = (0.9, 0.2, 0.1), 0.8
INSERT_ALBEDO, INSERT_ROUGHNESS, INSERT_IRRADIANCE = (0.3, 0.6, 0.9), 0.2, 0.7
DGRAD_FACTOR, ORBIT_FRAMES, ORBIT_FACTOR = 4, 3, 2
# The aux_cli phase: the training CLI on train_cli's scene with every aux
# head and the environment map, at 1024 rays (the heads' stored
# activations come on top of the 4096-ray update's), both aux losses and
# the split-sum shading from update CLI_SWITCH on, a checkpoint at
# AUX_N_ITER; a resume under Monte-Carlo shading to AUX_MC_N_ITER; then
# cli.test on that checkpoint with Monte-Carlo shading and the inferred
# normal at render factor AUX_FACTOR.
AUX_RAYS, AUX_N_ITER, AUX_MC_N_ITER, AUX_FACTOR = 1024, 20, 24, 2
AUX_FLAGS = ("--infer_normal", "--infer_depth", "--infer_albedo_separate",
             "--infer_roughness_separate", "--infer_irradiance_separate", "--infer_visibility",
             "--use_environment_map")
AUX_TRAINED = ("normal_mlp", "depth_mlp", "albedo_mlp", "roughness_mlp", "irradiance_mlp")
AUX_UNREAD = ("visibility_mlp", "env_map")   # no renderer reads them


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(phase: str, msg: str) -> None:
    emit(phase, ok=False, error=msg)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def field_macs(cfg: FieldConfig, density_only: bool, heads: str = "all") -> int:
    """Multiply-adds per point that the field needs (zero padding and
    the packed heads' zero columns not counted) for the density or a full
    query's head set (kernels/fused_field.HEAD_SETS)."""
    w, half, k = cfg.width, cfg.width // 2, cfg.coarse_radiance_number
    trunk = cfg.input_ch * w + 4 * w * w + (cfg.input_ch + w) * w + 2 * w * w
    if density_only:
        return trunk + w
    macs = trunk + (w * w + w * w + (w + cfg.input_ch_views) * w + w * k * half
                    + w + w + 3 * half + half + 3 * w + 3 * k * half)
    if heads != "all":      # no pos_feat, B or A's ρ column
        macs -= w * w + 3 * half + half + w
    if heads == "incident":  # no view_feat or D
        macs -= w * k * half + 3 * k * half
    return macs


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
K1_F64_SOURCE = "ibl_nerf_tpu_torch/csrc/fused_field_f64.cu"
# K1 full's launch on the training step's reflected march: 512 rays x 64
# coarse samples.
K1_TRAIN_SHAPE = (N_RAND, 64)
# K1 full's launch on the Monte-Carlo incident march of one 2048-ray chunk:
# mc_samples_axis² = 9 hemisphere directions a ray, each a ray of its own
# with its own view direction, over the 64 coarse samples.
MC_DIRS = 9
K1_MC_SHAPE = (CHUNK * MC_DIRS, 64)
# The f32 K1's head-set rows (kernels/fused_field.HEAD_SETS), named as their
# launch counters: (head set, point counts). The incident march of a
# Monte-Carlo chunk; the reflected march of a serving chunk and of the
# CLI's 4096-ray update.
K1_HEAD_ROWS = [("incident", [K1_MC_SHAPE]),
                ("reflected", [(CHUNK, 64), (CLI_RAYS, 64)])]
# Resident blocks per SM that the f32 K1's designs promise (csrc/fused_field.cu):
# the full variants' 256-thread blocks at 128 registers a thread; the density
# variant's 128-thread blocks at up to 255 registers (its 128-accumulator lane
# tile) and 86,768 B of shared memory, two of them so that one block's
# barriers overlap the other's FMAs.
K1_BLOCKS_PER_SM = 2
K1_DENSITY_BLOCKS_PER_SM = 2
# K1 density at f32 weights against its plain version, in relative norm:
# the trunk sums each activation in one FMA chain and σ's 256 products in
# another order than cuBLAS (2.5e-8 at 1,572,864 points on an H100).
K1_DENSITY_REL = 2e-7
# K1 density's ε sweeps beside the serving chunk's (K1_VARIANTS): a 4096-ray
# training update's coarse (64 samples) and fine (64 + 128) passes.
K1_DENSITY_SHAPES = [(4 * CLI_RAYS, 64), (4 * CLI_RAYS, 64 + 128)]
# the f32 kernel's HeadSet template argument (its mangled name) -> ptxas key
K1_PTXAS_SETS = {"0": "full", "1": "full_reflected", "2": "full_incident"}


def k1_ptxas(log: str, kernel: str = "fused_field_kernel") -> dict:
    """{"density" | "full" | "full_<set>": {registers, spill_stores,
    spill_loads}} of the variants of a K1 kernel (the f32 one, or
    "k1_bf16_field"), from nvcc's -Xptxas -v output of its source."""
    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            heads = re.search(r"HeadSetE(\d)E", m.group(1))
            entry = (("density" if "ILb1E" in m.group(1)
                      else K1_PTXAS_SETS[heads.group(1) if heads else "0"])
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


def k1_bound(cfg, packed, with_dirs: bool, points: int, peak: float = PEAK_F32_FLOPS,
             heads: str = "all"):
    """(FLOPs, bytes, ms at the `peak` rate, ms at the memory rate) of one
    K1 launch on `points` points (of head set `heads` if full): each
    input row, weight it reads (in the pack's dtype) and output row once."""
    n_cols = len(ff.head_columns(heads, cfg.coarse_radiance_number)) if with_dirs else 1
    skip = {"all": (), "reflected": ("wpf", "bpf", "B"),
            "incident": ("wpf", "bpf", "B", "wcf", "bcf", "D")}[heads]
    read = ([k for k in ff._WEIGHT_ORDER if k not in skip] if with_dirs else
            ["emb_E", "emb_phase", "emb_id", "w0", "w1", "w2", "w3", "w4",
             "w5x", "w5h", "w6", "w7", "tb", "A", "bias"])
    weight_bytes = sum(packed[k].numel() * packed[k].element_size() for k in read)
    flops = 2 * field_macs(cfg, density_only=not with_dirs, heads=heads) * points
    nbytes = points * (ff.IN_COLS + n_cols) * 4 + weight_bytes
    return flops, nbytes, flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3


def k1_head_row(cfg, packed, gen, heads: str, shapes: list, ptxas: dict) -> dict:
    """K1 full at f32 weights on head set `heads` at each of `shapes`: every
    kept column bit-equal to the "all" kernel's, a rerun bit-identical,
    within K1's gate of the plain version; timed in turns with "all" at the
    same points, each against the bound of the work it does."""
    occupancy = ff.occupancy(cfg, density_only=False, heads=heads)
    if occupancy["blocks_per_sm"] < K1_BLOCKS_PER_SM:
        fail("kernel", f"K1 {heads}: {occupancy['blocks_per_sm']} resident blocks per SM, "
             f"the design needs {K1_BLOCKS_PER_SM}")
    name = f"fused_field_apply_{heads}"
    cols = ff.head_columns(heads, cfg.coarse_radiance_number)
    at, max_abs = [], 0.0
    for lead in [(shapes[0][0] * shapes[0][1] + 37, 1), *shapes]:
        pts, dirs = k1_inputs(lead, gen)
        kern = lambda: ff.fused_field_apply(packed, pts, dirs, cfg, heads)  # noqa: E731
        full = lambda: ff.fused_field_apply(packed, pts, dirs, cfg)         # noqa: E731
        plain = lambda: ff.fused_field_apply_plain(packed, pts, dirs, cfg, heads)  # noqa: E731
        max_abs = max(max_abs, k1_check(name, kern, plain, lead)[0])
        out, again, every = kern(), kern(), full()
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            fail("kernel", f"{name} at {lead}: a rerun differs")
        off = int((out != every[..., cols]).sum())
        if off:
            fail("kernel", f"{name} at {lead}: {off} values differ from K1 full's columns")
        del out, again, every
        if lead not in shapes:
            continue
        iters = 5
        a1, k1, k2, a2 = (time_ms(full, iters), time_ms(kern, iters),
                          time_ms(kern, iters), time_ms(full, iters))
        n_pts = lead[0] * lead[1]
        flops, nbytes, t_ops, t_bytes = k1_bound(cfg, packed, True, n_pts, heads=heads)
        at.append(dict(points=n_pts, ms=[k1, k2], all_ms=[a1, a2],
                       bound_ms=max(t_ops, t_bytes),
                       all_bound_ms=max(k1_bound(cfg, packed, True, n_pts)[2:]),
                       flops=flops, bytes=nbytes, tflops=flops / ((k1 + k2) / 2) / 1e9))
        del pts, dirs
        torch.cuda.empty_cache()
    emit("kernel", name=name, heads=heads, columns=len(cols), at=at, max_abs_err=max_abs,
         atol=KERNEL_ATOL, rtol=KERNEL_RTOL, kept_columns_bit_equal=True,
         rerun_bit_identical=True, **occupancy,
         ptxas=ptxas.get(f"full_{heads}", "not built in this run"))
    main = at[0]
    return {"name": name, "route": "cuda",
            "source": "ibl_nerf_tpu_torch/csrc/fused_field.cu", "replaces": K1_SOURCE,
            "launches": None, "max_abs_err": max_abs, "points": main["points"],
            "ms": sum(main["ms"]) / 2, "all_ms": sum(main["all_ms"]) / 2,
            "plain_ms": None, "bound_ms": main["bound_ms"], "bound_by": "operations",
            "library_ms": None}


def k1_density_at(cfg, packed, gen, lead) -> dict:
    """K1 density on one ε sweep's shape: within K1's gate and
    K1_DENSITY_REL of its plain version (the phase fails outside either),
    timed in turns with it, beside its bound."""
    name = "fused_field_density"
    kern, plain = k1_calls(packed, cfg, *k1_inputs(lead, gen), False)
    max_abs = k1_check(name, kern, plain, lead)[0]
    rel = rel_err(kern(), plain())
    if rel > K1_DENSITY_REL:
        fail("kernel", f"{name} at {lead}: relative error {rel:.3e}, "
             f"the bound is {K1_DENSITY_REL}")
    p1, k1, k2, p2 = (time_ms(plain, 5), time_ms(kern, 5), time_ms(kern, 5),
                      time_ms(plain, 5))
    n_pts = lead[0] * lead[1]
    bound_ms = max(k1_bound(cfg, packed, False, n_pts)[2:])
    return dict(points=n_pts, rel_err=rel, max_abs_err=max_abs, ms=[k1, k2],
                plain_ms=[p1, p2], bound_ms=bound_ms,
                share_of_bound=bound_ms / ((k1 + k2) / 2))


def kernel_phase(cfg, packed, gen) -> list[dict]:
    """Both variants of K1 against the plain version, with their shared
    memory, resident blocks per SM and registers; K1 full also at the
    train step's shape, and its head sets as rows of their own; K1 density
    also at the training update's ε sweeps, each in relative norm, and
    with no spill store."""
    ptxas = k1_ptxas(kernel_build.build_logs.get("fused_field", ""))
    report = []
    for name, shape, with_dirs in K1_VARIANTS:
        n_pts = shape[0] * shape[1]
        occupancy = ff.occupancy(cfg, density_only=not with_dirs)
        need = K1_BLOCKS_PER_SM if with_dirs else K1_DENSITY_BLOCKS_PER_SM
        if occupancy["blocks_per_sm"] < need:
            fail("kernel", f"{name}: {occupancy['blocks_per_sm']} resident blocks per SM, "
                 f"the design needs {need}")
        if not with_dirs and ptxas.get("density", {}).get("spill_stores", 0):
            fail("kernel", f"{name}: spill stores {ptxas['density']}")

        def bound(points):
            return k1_bound(cfg, packed, with_dirs, points)

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
             other_head_counts_max_abs_err=k1_head_counts(cfg, gen) if with_dirs else None,
             at=None if with_dirs else [k1_density_at(cfg, packed, gen, lead)
                                        for lead in (shape, *K1_DENSITY_SHAPES)])
    report += [k1_head_row(cfg, packed, gen, heads, shapes, ptxas)
               for heads, shapes in K1_HEAD_ROWS]
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


def k1_f64_hold(name, kern, plain, lead, with_dirs: bool) -> dict:
    """One K1-f64 launch against its plain version: finite, bit-identical
    on a rerun and within K1_F64_REL relative norm, or the phase fails;
    its relative error, max abs error and the count of outputs not
    bit-equal to the plain version."""
    out, again, ref = kern(), kern(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail("kernel", f"{name}: non-finite output at {lead}")
    if not torch.equal(out, again):
        fail("kernel", f"{name}: two runs on the same inputs differ at {lead}")
    err = rel_err(out, ref)
    if not err <= K1_F64_REL[with_dirs]:
        fail("kernel", f"{name} at {lead}: off its plain version by {err:.3e} relative "
             f"(bound {K1_F64_REL[with_dirs]})")
    return {"rel_err": err, "max_abs_err": (out - ref).abs().max().item(),
            "not_bit_equal": int((out != ref).sum())}


def k1_f64_head_counts(cfg, gen, with_dirs: bool) -> dict:
    """K1 at f64 weights with 0, 1 and 4 coarse heads (no view_feat tile,
    a lone 128-column tile, two 256-column tiles; the main path has 3)
    against its plain version on a ragged count (`k1_f64_hold`): its
    relative error and outputs not bit-equal at each K."""
    out = {}
    for k in (0, 1, 4):
        kcfg = FieldConfig(depth=cfg.depth, width=cfg.width, coarse_radiance_number=k)
        params = init_field_params(np.random.default_rng(SEED + k), kcfg, "cuda")
        params["sigma"]["b"] += 0.5
        packed = ff.pack_field_weights(params, kcfg, dtype=torch.float64)
        kern, plain = k1_calls(packed, kcfg, *k1_inputs((4097, 1), gen), with_dirs)
        held = k1_f64_hold(f"K1-f64 ({'full' if with_dirs else 'density'}) at K={k}",
                           kern, plain, (4097, 1), with_dirs)
        out[k] = {"rel_err": held["rel_err"], "not_bit_equal": held["not_bit_equal"]}
    return out


def k1_f64_kernel_phase(cfg, params, gen) -> list[dict]:
    """K1's f64-weight variant (compute_dtype float64), both modes, at the
    serving path's shapes and at ragged counts (+37), full also at the
    Monte-Carlo march's K1_MC_SHAPE: against its plain version in
    relative norm under K1_F64_REL, twice bit-identical, with the outputs
    not bit-equal to it counted, and at K = 0, 1 and 4
    (`k1_f64_head_counts`); with its shared memory per block, blocks per
    SM and ptxas registers and spills, and its times in turns with the
    plain version's (at the Monte-Carlo shape too, for full)."""
    packed = ff.pack_field_weights(params, cfg, dtype=torch.float64)
    ptxas = k1_ptxas(kernel_build.build_logs.get("fused_field_f64", ""),
                     "fused_field_f64_kernel")
    # kernels/fused_field_f64.smem_bytes is the source's at every K it takes
    for k in range(ff.MAX_COARSE + 1):
        kcfg = FieldConfig(depth=cfg.depth, width=cfg.width, coarse_radiance_number=k)
        for density_only in (True, False):
            occ, mirror = k1d.occupancy(kcfg, density_only), k1d.smem_bytes(kcfg, density_only)
            if occ["smem_bytes_per_block"] != mirror or occ["blocks_per_sm"] < 1:
                fail("kernel", f"K1-f64 at K={k} (density {density_only}): {occ}, "
                     f"the Python mirror says {mirror} B")
    report = []
    for name, shape, with_dirs in K1_VARIANTS:
        name = name + "_f64"
        n_pts = shape[0] * shape[1]
        occupancy = k1d.occupancy(cfg, density_only=not with_dirs)
        if occupancy["blocks_per_sm"] < 1:
            fail("kernel", f"{name}: {occupancy}, no block fits an SM")

        def timed(kern, plain, points):
            """Kernel and plain ms in turns, and the bound, at `points`."""
            iters = 3 if points <= n_pts else 2
            kern(), plain()
            p1, k1, k2, p2 = (time_ms(plain, iters), time_ms(kern, iters),
                              time_ms(kern, iters), time_ms(plain, iters))
            return [k1, k2], [p1, p2], k1_bound(cfg, packed, with_dirs, points,
                                                PEAK_F64_FLOPS)

        held = {}
        for lead in ((n_pts + 37, 1), shape):
            kern, plain = k1_calls(packed, cfg, *k1_inputs(lead, gen), with_dirs)
            held[lead[0] * lead[1]] = k1_f64_hold(name, kern, plain, lead, with_dirs)
        torch.cuda.empty_cache()
        ms, plain_ms, (flops, nbytes, t_ops, t_bytes) = timed(kern, plain, n_pts)
        del kern, plain
        torch.cuda.empty_cache()
        mc = None
        if with_dirs:  # the Monte-Carlo incident march of a chunk
            n_mc = K1_MC_SHAPE[0] * K1_MC_SHAPE[1]
            kern, plain = k1_calls(packed, cfg, *k1_inputs(K1_MC_SHAPE, gen), True)
            mc = k1_f64_hold(name, kern, plain, K1_MC_SHAPE, True)
            mc_ms, mc_plain, (_, _, mc_ops, mc_bytes) = timed(kern, plain, n_mc)
            mc.update(points=n_mc, rays=K1_MC_SHAPE[0], ms=mc_ms, plain_ms=mc_plain,
                      bound_ms=max(mc_ops, mc_bytes))
            del kern, plain
            torch.cuda.empty_cache()
        max_abs = max(h["max_abs_err"] for h in held.values())
        not_bit_equal = sum(h["not_bit_equal"] for h in held.values())
        report.append({
            "name": name, "route": "cuda", "source": K1_F64_SOURCE,
            "replaces": K1_SOURCE,
            "launches": None, "max_abs_err": max_abs, "not_bit_equal": not_bit_equal,
            "ms": sum(ms) / 2, "plain_ms": sum(plain_ms) / 2,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            **({"mc_march": {"points": mc["points"], "ms": sum(mc["ms"]) / 2,
                             "plain_ms": sum(mc["plain_ms"]) / 2,
                             "bound_ms": mc["bound_ms"], "max_abs_err": mc["max_abs_err"],
                             "not_bit_equal": mc["not_bit_equal"]}} if mc else {}),
        })
        emit("kernel", name=name, points=n_pts, flops=flops, bytes=nbytes,
             held_by_points=held, rel_bound=K1_F64_REL[with_dirs], max_abs_err=max_abs,
             not_bit_equal=not_bit_equal, rerun_identical=True, ms=ms, plain_ms=plain_ms,
             bound_ops_ms=t_ops, bound_bytes_ms=t_bytes, tflops=flops / (sum(ms) / 2) / 1e9,
             **occupancy,
             ptxas=ptxas.get("full" if with_dirs else "density", "not built in this run"),
             mc_march=mc, other_head_counts=k1_f64_head_counts(cfg, gen, with_dirs))
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
        query_full = renderer.FieldQueries(params, rcfg).full
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


def k2_design_floor(w16: dict, n: int, residuals: bool = True) -> dict:
    """The least time K2's design could take on n points: the bytes of its
    own traffic in device memory over the memory rate. The pack reads each
    weight once and writes the slab stream; the forward reads x and the
    stream once (later tiles find it in L2) and writes raw and, with
    `residuals`, the 11 residual planes."""
    _, n_slabs = fft.forward_schedule(fft._shapes(w16))
    stream = n_slabs * fft.SLAB_N * fft.SLAB_K * 2
    n_out, width = w16["bias"].shape[0], w16["w1"].shape[0]
    pack = sum(v.numel() * 2 for v in w16.values()) + stream
    planes = len(fft._RES_ORDER) * width * 2 if residuals else 0
    fwd = n * (ff.IN_COLS * 4 + n_out * 4 + planes) + stream
    ms = {k: b / PEAK_BYTES * 1e3 for k, b in (("pack", pack), ("forward", fwd))}
    return {**ms, "both": ms["pack"] + ms["forward"], "bytes": pack + fwd}


# K2's point counts in the benchmark's cells: an update's coarse pass (4096
# rays x 64 samples), its fine pass (x 192) and a 2048-ray render chunk's
# fine pass (x 192)
K2_CELL_SHAPES = (4096 * 64, 4096 * 192, 2048 * 192)


def train_kernel_phase(cfg, field_params, gen) -> list[dict]:
    """K2 and K3 against their plain versions at the fine-pass (512x192)
    and coarse-pass (512x64) point counts, at the benchmark cells' K2
    shapes (`K2_CELL_SHAPES`, the largest also ragged) and at ragged ones
    (1 and 63 points: fewer pipeline stages than the ring holds; 4,097: a
    point range of one stage), each rerun for bit-equality; K2's variant
    without residual stores against its raw bit for bit; K3 on the kernel
    K2's residuals against the plain backward of the plain forward; their
    gradients against the eager paths'; timed at the fine-pass shape and
    by stage, K2 also at the cells' shapes with and without residuals."""
    w16 = fft.to_bf16(ff.pack_field_weights(field_params, cfg))
    emb = fft.emb_constants(cfg, torch.device("cuda"))
    n_out = 9 + 3 * cfg.coarse_radiance_number
    fine, coarse = 512 * (64 + 128), 512 * 64
    errs = {"fwd": {}, "nores": {}, "bwd": {}, "chain": {}}
    for n in (1, 63, 4097, fine + 37, coarse, *K2_CELL_SHAPES, K2_CELL_SHAPES[1] + 37, fine):
        pts = torch.rand((n, 1, 3), device="cuda", generator=gen) * 4 - 2
        dirs = torch.nn.functional.normalize(
            torch.randn((n, 3), device="cuda", generator=gen), dim=-1)
        x = ff._pack_inputs(pts, dirs)
        g = torch.randn((n, n_out), device="cuda", generator=gen) * 1e-3
        raw, res = fft._launch_fwd(x, w16, emb)
        raw_again, res_again = fft._launch_fwd(x, w16, emb)
        raw_nr, res_nr = fft._launch_fwd(x, w16, emb, residuals=False)
        raw_nr_again, _ = fft._launch_fwd(x, w16, emb, residuals=False)
        raw_p, res_p = fft.train_forward_plain(x, w16, emb)
        dw = fft._launch_bwd(x, g, res_p, w16, emb)
        dw_again = fft._launch_bwd(x, g, res_p, w16, emb)
        dw_k2 = fft._launch_bwd(x, g, res, w16, emb)   # fed the kernel K2's residuals
        dw_p = fft.train_backward_plain(x, g, res_p, w16, emb)
        torch.cuda.synchronize()
        fwd = {"raw": rel_err(raw, raw_p)}
        fwd.update({k: rel_err(res[i], res_p[i]) for i, k in enumerate(fft._RES_ORDER)})
        bwd = {k: rel_err(dw[k], dw_p[k]) for k in fft._DW_ORDER}
        chain = {k: rel_err(dw_k2[k], dw_p[k]) for k in fft._DW_ORDER}
        if not torch.isfinite(raw).all() or not all(torch.isfinite(v).all() for v in dw.values()):
            fail("kernel", f"K2/K3: non-finite output at {n} points")
        if not (torch.equal(raw, raw_again) and torch.equal(res, res_again)):
            fail("kernel", f"K2: two runs on the same inputs differ at {n} points")
        if res_nr is not None or not (torch.equal(raw_nr, raw)
                                      and torch.equal(raw_nr, raw_nr_again)):
            fail("kernel", f"K2 without residual stores: raw not bit-equal to K2's, or to its "
                 f"own rerun, or planes returned at {n} points")
        if not all(torch.equal(dw[k], dw_again[k]) for k in fft._DW_ORDER):
            fail("kernel", f"K3: two runs on the same inputs differ at {n} points")
        for name, e in (("K2", fwd), ("K3", bwd), ("K3 on K2's residuals", chain)):
            worst = max(e, key=e.get)
            if not e[worst] <= TRAIN_KERNEL_REL:
                fail("kernel", f"{name} at {n} points: block {worst} off by "
                     f"{e[worst]:.3e} relative (bound {TRAIN_KERNEL_REL})")
        errs["fwd"][n], errs["nores"][n], errs["bwd"][n], errs["chain"][n] = (
            fwd, {"raw": fwd["raw"]}, bwd, chain)
        max_abs = {"fwd": (raw - raw_p).abs().max().item(),
                   "bwd": max((dw[k] - dw_p[k]).abs().max().item() for k in dw)}
        max_abs["nores"] = max_abs["fwd"]
        del raw, res, raw_again, res_again, raw_nr, raw_nr_again, raw_p, res_p
        del dw, dw_again, dw_k2, dw_p
        torch.cuda.empty_cache()
    res_p = fft.train_forward_plain(x, w16, emb)[1]

    grad_err = field_grad_errors(cfg, field_params, gen, 512, 64 + 128)
    if not grad_err["kernels"] <= GRAD_RATIO * grad_err["eager_bf16"]:
        fail("kernel", f"K2/K3 field gradient error {grad_err['kernels']:.3e} exceeds "
             f"{GRAD_RATIO} x the eager bf16 field's {grad_err['eager_bf16']:.3e}")
    emit("kernel", name="fused_field_train_grad", points=fine,
         grad_rel_err_vs_f32=grad_err, ratio_bound=GRAD_RATIO)

    # timing at the fine-pass shape, in turns: plain, kernel, kernel, plain
    iters = 5
    f_flop, b_flop = train_field_flops(cfg)
    f_flops, b_flops = f_flop * fine, b_flop * fine
    weight_bytes = sum(v.numel() * 2 for v in w16.values())
    raw_bytes = ff.IN_COLS * 4 + n_out * 4            # a point's input and raw
    res_bytes = len(fft._RES_ORDER) * cfg.width * 2   # and its residual planes
    io_bytes = fine * (raw_bytes + res_bytes)
    dw_bytes = sum(v.numel() * 4 for v in w16.values())
    cases = [
        ("fused_field_train_fwd", "ibl_nerf_tpu/kernels/fused_field_train.py:110",
         lambda: fft._launch_fwd(x, w16, emb),
         lambda: fft.train_forward_plain(x, w16, emb),
         f_flops, io_bytes + weight_bytes, "fwd"),
        ("fused_field_train_fwd_nores", "ibl_nerf_tpu/kernels/fused_field_train.py:110",
         lambda: fft._launch_fwd(x, w16, emb, residuals=False),
         lambda: fft.train_forward_plain(x, w16, emb, residuals=False),
         f_flops, fine * raw_bytes + weight_bytes, "nores"),
        ("fused_field_train_bwd", "ibl_nerf_tpu/kernels/fused_field_train.py:143",
         lambda: fft._launch_bwd(x, g, res_p, w16, emb),
         lambda: fft.train_backward_plain(x, g, res_p, w16, emb),
         b_flops, io_bytes + weight_bytes + dw_bytes, "bwd"),
    ]
    report = []
    for name, replaces, kern, plain, flops, nbytes, which in cases:
        kern(), plain()
        p1, k1, k2, p2 = (time_ms(plain, iters), time_ms(kern, iters),
                          time_ms(kern, iters), time_ms(plain, iters))
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        worst = {n: max(e.values()) for n, e in errs[which].items()}
        stages = stage_ms(kern, "k3_" if which == "bwd" else "k2_")
        floor = (k3_design_floor(w16, fine) if which == "bwd"
                 else k2_design_floor(w16, fine, residuals=which == "fwd"))
        extra = {}
        if which == "bwd":
            extra["worst_rel_err_on_k2_residuals_by_points"] = {
                n: max(e.values()) for n, e in errs["chain"].items()}
        else:   # K2 at the cells' shapes
            extra["cells_ms"] = k2_cell_times(cfg, w16, emb, gen, which == "fwd",
                                              raw_bytes, res_bytes, weight_bytes)
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
             tflops=flops / ((k1 + k2) / 2) / 1e9, stage_ms=stages, **extra)
    return report


def k2_cell_times(cfg, w16, emb, gen, residuals: bool, raw_bytes: int, res_bytes: int,
                  weight_bytes: int) -> dict:
    """K2 (with or without residual stores) at each of `K2_CELL_SHAPES`:
    ms of two timed runs (CUDA events) and the bound at that shape, the
    larger of the products at the bf16 peak and the bytes at the memory
    rate."""
    f_flop = train_field_flops(cfg)[0]
    out = {}
    for n in K2_CELL_SHAPES:
        pts = torch.rand((n, 1, 3), device="cuda", generator=gen) * 4 - 2
        dirs = torch.nn.functional.normalize(
            torch.randn((n, 3), device="cuda", generator=gen), dim=-1)
        x = ff._pack_inputs(pts, dirs)

        def kern():
            return fft._launch_fwd(x, w16, emb, residuals=residuals)

        kern()
        ms = [time_ms(kern, 5), time_ms(kern, 5)]
        nbytes = n * (raw_bytes + (res_bytes if residuals else 0)) + weight_bytes
        bound = max(f_flop * n / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        out[n] = {"ms": ms, "bound_ms": bound, "ns_per_point": min(ms) * 1e6 / n}
        del x
        torch.cuda.empty_cache()
    return out


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
    # "fused_field_apply" counts the head-set launches too: their rows stand for it
    rows = {r["name"]: r["ms"] for r in kernels if r["name"] in expect}
    if "fused_field_apply_reflected" in rows:
        del rows["fused_field_apply"]
    k1_ms = sum(rows.values())
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
                   {"fused_field_density": 1, "fused_field_apply": 1,
                    "fused_field_apply_reflected": 1})
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


def profile_steps(run_step, n=2) -> dict:
    """Kernel time on the device over n calls of `run_step` (one train
    step each; torch.profiler), the share of K1/K2/K3 in it, and the
    device's busy share of the profiled host-clock window (the profiler
    slows the host). Empty when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
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
            "fused_field_apply": 2 * steps, "fused_field_apply_reflected": 2 * steps}
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
                  profile=profile_steps(lambda: step(state, arrays, generator=gen)))
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
                  profile=profile_steps(lambda: step(state, arrays, generator=gen)))
    emit("train_mixed", **report)
    return report


def _mitsuba_pose(c2w: np.ndarray) -> np.ndarray:
    """The 4x4 transform a Mitsuba scene stores for camera-to-world
    `c2w`: the loader negates the x and z columns, so they are negated
    here first."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :4] = c2w
    pose[:3, 0] *= -1
    pose[:3, 2] *= -1
    return pose


def write_cli_scene(root: Path, seed: int = SEED) -> float:
    """A Mitsuba scene at 480x640 from a seed, written with the port's PNG
    encoder: `train/{i}.png` with `_normal` and `_albedo`, `test/{i}.png`
    with `_normal`, `_albedo` and `_irradiance`, the transforms and the
    depth range. Returns the seconds it took."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:TRAIN_H, 0:TRAIN_W].astype(np.float32)
    base = np.stack([xx / TRAIN_W, yy / TRAIN_H, 0.5 + 0.5 * np.sin(xx / 37.0)], -1)
    n = np.stack([0.3 * np.sin(xx / 91.0), 0.3 * np.cos(yy / 73.0), np.ones_like(xx)], -1)
    normal = (n / np.linalg.norm(n, axis=-1, keepdims=True) + 1.0) * 0.5

    def png(path, img01):
        write_png(str(path), (np.clip(img01, 0, 1) * 255).astype(np.uint8))

    (root).mkdir(parents=True)
    with open(root / "min_max_depth.json", "w") as f:
        json.dump({"min_depth": 2.0, "max_depth": 6.0}, f)
    for split, count, extra in (("train", CLI_TRAIN_IMAGES, ()),
                                ("test", CLI_TEST_IMAGES, ("irradiance",))):
        d = root / split
        d.mkdir()
        frames = []
        for i in range(1, count + 1):
            img = np.clip(base * 0.7 + 0.3 * rng.uniform(0, 1, 3)
                          + 0.02 * rng.standard_normal(base.shape), 0, 1)
            png(d / f"{i}.png", img)
            png(d / f"{i}_normal.png", normal)
            png(d / f"{i}_albedo.png", img * 0.8)
            if split == "test" and i == 1:
                write_eval_buffers(d)
            if "irradiance" in extra:
                png(d / f"{i}_irradiance.png", np.repeat((0.5 + 0.2 * yy / TRAIN_H)[..., None], 3, -1))
            a = 0.4 * (i - 1) / max(count - 1, 1) - 0.2
            c2w = _look_at(np.array([4 * np.sin(a), 0.5, 4 * np.cos(a)]))
            frames.append({"fov_degree": 50.0, "transform": _mitsuba_pose(c2w).tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"frames": frames}, f)
    return time.perf_counter() - t0


def write_eval_buffers(d: Path) -> None:
    """Test frame 1's edit and insert inputs: both masks hold one object
    (gray 10/255 in EVAL_MASK), the insert depth is 3.0 there and its
    normal +y."""
    mask = np.zeros((TRAIN_H, TRAIN_W, 3), np.uint8)
    mask[EVAL_MASK] = 10
    write_png(str(d / "1_edit_intrinsic_mask.png"), mask)
    write_png(str(d / "1_insert_mask.png"), mask)
    np.save(d / "1_insert_depth.npy", np.full((TRAIN_H, TRAIN_W), 3.0, np.float32))
    normal = np.zeros((TRAIN_H, TRAIN_W, 3), np.uint8)
    normal[...] = (128, 255, 128)
    write_png(str(d / "1_insert_normal.png"), normal)


def _launch_counts() -> dict:
    return {**ff.LAUNCHES, **fft.LAUNCHES}


@contextlib.contextmanager
def cli_probes(record: dict, snapshot_at: tuple = (), profiled: int = CLI_PROFILED):
    """Within the block, the trainer's PNG decodes, pyramid builds, train
    steps and test-set renders are timed (steps and renders synchronised
    on the device first), and each step's update index and kernel
    launches, and each render's launches, are recorded into `record`.
    The step of update `profiled` runs under torch.profiler instead of
    being timed: its breakdown goes to record["profile"]. Before the step
    of each update in `snapshot_at`, a copy of the params goes to
    record["params_before"][update]."""
    originals = {(dataset_mod, "_load_images"): dataset_mod._load_images,
                 (dataset_mod, "build_prefiltered_pyramid"): dataset_mod.build_prefiltered_pyramid,
                 (loop_mod, "render_path"): loop_mod.render_path,
                 (loop_mod, "make_train_step"): loop_mod.make_train_step,
                 (loop_mod, "_step_generator"): loop_mod._step_generator}

    def timed(name, fn, sync=False, launches=False):
        def run(*args, **kwargs):
            before = _launch_counts()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            entry = {"s": time.perf_counter() - t0}
            if launches:
                after = _launch_counts()
                entry["launches"] = {k: after[k] - before[k] for k in after}
            record.setdefault(name, []).append(entry)
            return out
        return run

    def make_train_step(*args, **kwargs):
        step = originals[(loop_mod, "make_train_step")](*args, **kwargs)
        timed_step = timed("steps", step, sync=True, launches=True)

        def run(*a, **kw):
            if record["updates"][-1] in snapshot_at:
                record.setdefault("params_before", {})[record["updates"][-1]] = {
                    name: [p.detach().clone() for p in _leaves(v)]
                    for name, v in a[0].variables.items()}
            if record["updates"][-1] != profiled:
                return timed_step(*a, **kw)
            out = []
            before = _launch_counts()
            record["profile"] = profile_steps(lambda: out.append(step(*a, **kw)), n=1)
            after = _launch_counts()
            record["steps"].append({"s": None, "launches": {k: after[k] - before[k]
                                                            for k in after}})
            return out[0]
        return run

    def step_generator(seed, i, device):
        record.setdefault("updates", []).append(i)
        return originals[(loop_mod, "_step_generator")](seed, i, device)

    dataset_mod._load_images = timed("decode", originals[(dataset_mod, "_load_images")])
    dataset_mod.build_prefiltered_pyramid = timed(
        "pyramid", originals[(dataset_mod, "build_prefiltered_pyramid")])
    loop_mod.render_path = timed("render", originals[(loop_mod, "render_path")],
                                 sync=True, launches=True)
    loop_mod.make_train_step = make_train_step
    loop_mod._step_generator = step_generator
    try:
        yield
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)


def cli_argv(n_iter: int) -> list[str]:
    return ["--datadir", str(CLI_DIR / "scene"), "--basedir", str(CLI_DIR / "logs"),
            "--expname", "train_cli", "--use_pallas", "--use_pallas_train",
            "--coarse_radiance_number", "3", "--N_samples", "64", "--N_importance", "128",
            "--load_depth_range_from_file", "--N_iter", str(n_iter),
            "--N_iter_ignore_approximated_radiance", str(CLI_SWITCH),
            "--i_weights", str(CLI_N_ITER), "--i_testset", str(CLI_N_ITER),
            "--i_video", "1000000", "--summary_step", "5"]


def _per_step(steps: list, updates: list, lo: int, hi: int, rays: int = CLI_RAYS) -> dict:
    """ms per step (median, mean) and train rays/s over updates lo..hi-1."""
    ms = [e["s"] * 1e3 for e, i in zip(steps, updates) if lo <= i < hi and e["s"]]
    med = float(np.median(ms))
    return {"updates": [lo, hi - 1], "ms_per_step_median": med,
            "ms_per_step_mean": float(np.mean(ms)), "ms_per_step_min": min(ms),
            "ms_per_step_max": max(ms), "rays_per_s_at_median": rays / med * 1e3}


def train_cli_phase(kernels, card: str) -> dict:
    """The training CLI from a scene directory, then a resume; see the
    module docstring for its gates."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    write_s = write_cli_scene(CLI_DIR / "scene")
    logdir = CLI_DIR / "logs" / "train_cli"

    for c in (ff.LAUNCHES, fft.LAUNCHES):
        for k in c:
            c[k] = 0
    torch.cuda.reset_peak_memory_stats()
    first, second = {}, {}
    t0 = time.perf_counter()
    with cli_probes(first):
        state = cli_train.main(cli_argv(CLI_N_ITER))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with cli_probes(second):
        resumed = cli_train.main(cli_argv(CLI_RESUME_N_ITER))
    torch.cuda.synchronize()

    steps, updates = first["steps"], first["updates"]
    if updates != list(range(CLI_N_ITER + 1)) or state.step != CLI_N_ITER + 1:
        fail("train_cli", f"updates {updates[:3]}...{updates[-3:]}, step {state.step}: "
             f"expected 0..{CLI_N_ITER}")
    for e, i in zip(steps, updates):
        k1 = 2 if i >= CLI_SWITCH else 0
        want = {"fused_field_train_fwd": 2, "fused_field_train_bwd": 2, "fused_field_apply": k1,
                "fused_field_apply_reflected": k1}
        got = {k: v for k, v in e["launches"].items() if v}
        if got != {k: v for k, v in want.items() if v}:
            fail("train_cli", f"update {i} launched {got}, expected {want}")
    (render,) = first["render"]
    n_chunks = -(-TRAIN_H * TRAIN_W // CLI_CHUNK)
    # per chunk: the fine pass's primary march on K2 (the gradient-path
    # query, as in JAX's render; no backward, so without residual stores)
    # and its reflected march on K1 full
    want = {"fused_field_apply": n_chunks, "fused_field_apply_reflected": n_chunks,
            "fused_field_train_fwd_nores": n_chunks}
    if {k: v for k, v in render["launches"].items() if v} != want:
        fail("train_cli", f"the test-set render launched {render['launches']}, expected "
             f"{want} (one of each per chunk) and nothing else")
    if launches["fused_field_density"] or launches["fused_field_density_bf16"]:
        fail("train_cli", f"K1 density launched: {launches}")

    records = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    losses = [r["loss_total"] for r in records if "loss_total" in r]
    if not losses or not np.all(np.isfinite(losses)):
        fail("train_cli", f"losses {losses}")
    ckpts = sorted(p.name for p in logdir.glob("ckpt_*"))
    if ckpts != ["ckpt_000000", f"ckpt_{CLI_N_ITER:06d}"]:
        fail("train_cli", f"checkpoints {ckpts}")
    if (second["updates"] != list(range(CLI_N_ITER + 1, CLI_RESUME_N_ITER + 1))
            or resumed.step != CLI_RESUME_N_ITER + 1):
        fail("train_cli", f"the resume ran updates {second['updates']} to step "
             f"{resumed.step}; expected {CLI_N_ITER + 1}..{CLI_RESUME_N_ITER}")
    pngs = sorted((logdir / f"testset_{CLI_N_ITER:06d}").glob("*.png"))
    decoded = native_loader.batch_load_png_rgb([str(p) for p in pngs], TRAIN_H, TRAIN_W)
    if len(pngs) < 20 or not np.isfinite(decoded).all():
        fail("train_cli", f"{len(pngs)} test-set PNGs")
    for p in pngs[:3]:
        if native_loader.probe_png(str(p))[:2] != (TRAIN_H, TRAIN_W):
            fail("train_cli", f"{p.name} is not {TRAIN_H}x{TRAIN_W}")

    n_updates = CLI_N_ITER + 1
    per_step = {k: sum(e["launches"][k] for e in steps) / n_updates for k in launches}
    for row in kernels:
        row.setdefault("launches_by_phase", {})["train_cli"] = launches.get(row["name"], 0)
    report = dict(
        card=card, rays=CLI_RAYS, height=TRAIN_H, width=TRAIN_W,
        train_images=CLI_TRAIN_IMAGES, scene_write_s=write_s,
        decode_s=sum(e["s"] for e in first["decode"]),
        decode_calls=len(first["decode"]),
        pyramid_s=sum(e["s"] for e in first["pyramid"]),
        run_s=run_s, updates=n_updates,
        before_switch=_per_step(steps, updates, 2, CLI_SWITCH),
        after_switch=_per_step(steps, updates, CLI_SWITCH + 2, n_updates),
        resumed=_per_step(second["steps"], second["updates"], CLI_N_ITER + 1,
                          CLI_RESUME_N_ITER + 1),
        testset_render_s=render["s"], testset_rays=TRAIN_H * TRAIN_W,
        testset_chunks=n_chunks, pngs=len(pngs),
        launches=launches, launches_per_update=per_step,
        launches_render=render["launches"],
        peak_memory_bytes=peak, losses=losses, checkpoints=ckpts,
        resume_updates=[second["updates"][0], second["updates"][-1]],
        profile={"update": CLI_PROFILED, **first.get("profile", {})})
    emit("train_cli", **report)
    return report


def eval_argv(*extra) -> list[str]:
    """The test and render CLIs' flags on train_cli's run: its scene,
    logdir, field and samples, K1 and K2/K3 on, the defaults otherwise
    (gt normals, bf16_grad, render factor 1)."""
    return ["--datadir", str(CLI_DIR / "scene"), "--basedir", str(CLI_DIR / "logs"),
            "--expname", "train_cli", "--use_pallas", "--use_pallas_train",
            "--coarse_radiance_number", "3", "--N_samples", "64", "--N_importance", "128",
            "--load_depth_range_from_file", *extra]


@contextlib.contextmanager
def eval_probes(record: dict):
    """Within the block, the CLIs' renders, the mesh's density grid and
    its marching cubes are timed (synchronised on the device first) into
    `record`."""
    originals = {(cli_test, "render_path"): cli_test.render_path,
                 (cli_render, "render_path"): cli_render.render_path,
                 (mesh_extract, "query_density_grid"): mesh_extract.query_density_grid,
                 (mesh_extract, "marching_cubes"): mesh_extract.marching_cubes}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return run

    for (mod, name), fn in originals.items():
        setattr(mod, name, timed("render" if name == "render_path" else name, fn))
    try:
        yield
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)


def read_avi(path: Path) -> tuple[np.ndarray, float, dict]:
    """(frames (N, H, W, 3) RGB uint8, fps, counts) of an uncompressed
    24-bit AVI: the `00db` chunks of every RIFF list's `movi`, in file
    order (AVI 1.0 or OpenDML). counts: the RIFF forms, and the frame
    counts of avih (the first RIFF's), strh and dmlh (all; None without
    OpenDML)."""
    data = path.read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path} is not an AVI file")
    i = data.index(b"strh")
    scale, rate = struct.unpack("<II", data[i + 28:i + 36])
    strh_frames = struct.unpack("<I", data[i + 40:i + 44])[0]
    i = data.index(b"strf")
    _, w, h = struct.unpack("<Iii", data[i + 8:i + 20])
    i = data.index(b"avih")
    avih_frames = struct.unpack("<I", data[i + 24:i + 28])[0]
    dmlh = data.find(b"dmlh")
    row, frames, forms, pos = (3 * w + 3) // 4 * 4, [], [], 0
    while pos < len(data):
        riff_end = pos + 8 + struct.unpack("<I", data[pos + 4:pos + 8])[0]
        forms.append(data[pos + 8:pos + 12].decode())
        q = pos + 12
        while q < riff_end:
            kind, size = data[q:q + 4], struct.unpack("<I", data[q + 4:q + 8])[0]
            if kind == b"LIST" and data[q + 8:q + 12] == b"movi":
                c = q + 12
                while c < q + 8 + size:
                    n = struct.unpack("<I", data[c + 4:c + 8])[0]
                    if data[c:c + 4] == b"00db":
                        img = np.frombuffer(data, np.uint8, n, c + 8).reshape(abs(h), row)
                        img = img[:, :3 * w].reshape(abs(h), w, 3)[..., ::-1]
                        frames.append(img if h < 0 else img[::-1])
                    c += 8 + n + n % 2
            q += 8 + size + size % 2
        pos = riff_end
    counts = {"riffs": forms, "avih": avih_frames, "strh": strh_frames,
              "dmlh": struct.unpack("<I", data[dmlh + 8:dmlh + 12])[0] if dmlh >= 0 else None}
    return np.stack(frames), rate / scale, counts


def read_mp4(path: Path) -> tuple[np.ndarray, float]:
    """(frames (N, H, W, 3) RGB uint8, fps) of utils/video.write_mp4's
    file: raw 24-bit samples of one size at the co64 offsets."""
    data = path.read_bytes()
    i = data.index(b"raw ")
    w, h = struct.unpack(">HH", data[i + 28:i + 32])
    timescale = struct.unpack(">I", data[data.index(b"mdhd") + 16:data.index(b"mdhd") + 20])[0]
    delta = struct.unpack(">I", data[data.index(b"stts") + 16:data.index(b"stts") + 20])[0]
    i = data.index(b"stsz")
    size, n = struct.unpack(">II", data[i + 8:i + 16])
    i = data.index(b"co64")
    offsets = np.frombuffer(data, ">u8", n, i + 12)
    if size != 3 * w * h:
        raise ValueError(f"{path}: {size}-byte samples for {w}x{h} frames")
    return np.stack([np.frombuffer(data, np.uint8, size, int(o)).reshape(h, w, 3)
                     for o in offsets]), timescale / delta


def eval_cli_phase(kernels, card: str) -> dict:
    """The test and render CLIs on train_cli's newest checkpoint; see
    the module docstring for its gates."""
    phase = "eval_cli"
    record, runs, totals = {}, {}, {k: 0 for k in _launch_counts()}

    def run(name, fn, argv, expect_per_chunk, n_chunks):
        for c in (ff.LAUNCHES, fft.LAUNCHES):
            for k in c:
                c[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with eval_probes(record):
            results = fn(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        for k, v in launches.items():
            totals[k] += v
        want = {k: v * n_chunks for k, v in expect_per_chunk.items()}
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            fail(phase, f"{name} launched {got}, expected {want} ({expect_per_chunk} in each "
                 f"of {n_chunks} chunks) and nothing else")
        for k, v in results.items():
            if not np.isfinite(v).all():
                fail(phase, f"{name}: buffer {k} has non-finite values")
        runs[name] = {"s": seconds, "render_s": record["render"][-1], "chunks": n_chunks,
                      "launches": got}
        return results

    full_chunks = -(-TRAIN_H * TRAIN_W // CLI_CHUNK)
    # reflected march + primary march (K2 without residual stores: no backward)
    primary = {"fused_field_apply": 1, "fused_field_apply_reflected": 1,
               "fused_field_train_fwd_nores": 1}

    # cli.test at 480x640 with the mesh: one K1 full and one K2 (no residual
    # stores) a chunk, no K1 density
    plain = run("test", cli_test.main, eval_argv("--extract_mesh"), primary, full_chunks)
    testdir = CLI_DIR / "logs_eval" / "train_cli" / f"testset_{CLI_N_ITER:06d}"
    pngs = sorted(testdir.glob("*.png"))
    if len(pngs) < 20 or any(native_loader.probe_png(str(p))[:2] != (TRAIN_H, TRAIN_W)
                             for p in pngs):
        fail(phase, f"{len(pngs)} PNGs in {testdir}, or one not {TRAIN_H}x{TRAIN_W}")
    decoded = native_loader.batch_load_png_rgb([str(p) for p in pngs], TRAIN_H, TRAIN_W)
    if not np.isfinite(decoded).all():
        fail(phase, "a test-set PNG decodes to non-finite values")
    gt = native_loader.batch_load_png_rgb([str(CLI_DIR / "scene" / "test" / "1.png")],
                                          TRAIN_H, TRAIN_W)
    metrics = batch_metrics(plain["rgb"], gt)
    mesh = (testdir / "mesh.obj").read_text().splitlines()
    n_verts = sum(ln.startswith("v ") for ln in mesh)
    n_faces = sum(ln.startswith("f ") for ln in mesh)

    # edit and insert on frame 1: outside the mask every buffer is the plain
    # render's, bit for bit; inside, the intrinsics are their targets
    outside = np.ones((TRAIN_H, TRAIN_W), bool)
    outside[EVAL_MASK] = False
    albedo_flags = sum((["--editing_target_albedo_list", str(v)] for v in EVAL_ALBEDO), [])
    edited = run("edit", cli_test.main, eval_argv(
        "--edit_intrinsic", "--editing_img_idx", "1", "--edit_albedo", "--edit_roughness",
        *albedo_flags, "--editing_target_roughness_list", str(EVAL_ROUGHNESS),
        "--export_basedir", str(CLI_DIR / "eval_edit")), primary, full_chunks)
    insert_flags = sum((["--inserting_target_albedo_list", str(v)] for v in INSERT_ALBEDO), [])
    inserted = run("insert", cli_test.main, eval_argv(
        "--insert_object", "--inserting_img_idx", "1", *insert_flags,
        "--inserting_target_roughness_list", str(INSERT_ROUGHNESS),
        "--inserting_target_irradiance_list", str(INSERT_IRRADIANCE),
        "--export_basedir", str(CLI_DIR / "eval_insert")), primary, full_chunks)
    targets = {"edit": (edited, {"albedo": EVAL_ALBEDO, "roughness": EVAL_ROUGHNESS}),
               "insert": (inserted, {"albedo": INSERT_ALBEDO, "roughness": INSERT_ROUGHNESS,
                                     "irradiance": INSERT_IRRADIANCE})}
    for name, (res, want) in targets.items():
        if set(res) != set(plain):
            fail(phase, f"{name}: buffers {sorted(res)} against {sorted(plain)}")
        for k, v in res.items():
            if not np.array_equal(v[0][outside], plain[k][0][outside]):
                fail(phase, f"{name}: {k} differs from the plain render outside the mask")
        for k, target in want.items():
            inside = res[k][0][EVAL_MASK]
            err = float(np.abs(inside - np.asarray(target, np.float32)).max())
            if err > 1e-6:
                fail(phase, f"{name}: {k} inside the mask is {err:.3e} from its target")

    # autograd depth-gradient normals at render factor 4: eager forward mode
    h4, w4 = TRAIN_H // DGRAD_FACTOR, TRAIN_W // DGRAD_FACTOR
    dgrad = run("depth_gradient", cli_test.main, eval_argv(
        "--calculating_normal_type", "normal_map_from_depth_gradient",
        "--render_factor", str(DGRAD_FACTOR), "--export_basedir", str(CLI_DIR / "eval_dgrad")),
        primary, -(-h4 * w4 // CLI_CHUNK))
    normal = 2.0 * dgrad["target_normal_map"] - 1.0
    norm_err = float(np.abs(np.linalg.norm(normal, axis=-1) - 1.0).max())
    if normal.shape != (1, h4, w4, 3) or not norm_err < 1e-4:
        fail(phase, f"depth-gradient normals {normal.shape}, | |n| - 1 | up to {norm_err}")

    # cli.render: a 3-frame orbit, ε normals in place of the gt ones (K1 density)
    h2, w2 = TRAIN_H // ORBIT_FACTOR, TRAIN_W // ORBIT_FACTOR
    orbit = run("render", cli_render.main, eval_argv(
        "--orbit_frames", str(ORBIT_FRAMES), "--render_factor", str(ORBIT_FACTOR)),
        {**primary, "fused_field_density": 1}, ORBIT_FRAMES * -(-h2 * w2 // CLI_CHUNK))
    orbit_dir = CLI_DIR / "logs" / "train_cli" / f"orbit_{CLI_N_ITER:06d}"
    frames, fps, _ = read_avi(orbit_dir / "rgb.avi")
    want = (np.clip(orbit["rgb"], 0, 1) * 255).astype(np.uint8)
    if fps != 30.0 or frames.shape != (ORBIT_FRAMES, h2, w2, 3) or not np.array_equal(
            frames, want):
        fail(phase, f"rgb.avi: {frames.shape} at {fps} fps does not hold the rgb stack")

    for row in kernels:
        row.setdefault("launches_by_phase", {})[phase] = totals.get(row["name"], 0)
    report = dict(
        card=card, checkpoint=f"ckpt_{CLI_N_ITER:06d}", height=TRAIN_H, width=TRAIN_W,
        test_s_per_image=runs["test"]["render_s"], test_run_s=runs["test"]["s"],
        psnr=metrics["psnr"], ssim=metrics["ssim"], pngs=len(pngs),
        mesh_grid_s=record["query_density_grid"][0], mesh_marching_cubes_s=record[
            "marching_cubes"][0], mesh_vertices=n_verts, mesh_faces=n_faces,
        edit_s=runs["edit"]["s"], edit_render_s=runs["edit"]["render_s"],
        insert_s=runs["insert"]["s"], insert_render_s=runs["insert"]["render_s"],
        depth_gradient_render_s=runs["depth_gradient"]["render_s"],
        depth_gradient_size=[h4, w4], normal_unit_err=norm_err,
        orbit_s_per_frame=runs["render"]["render_s"] / ORBIT_FRAMES,
        orbit_size=[h2, w2], orbit_run_s=runs["render"]["s"], avi_frames=len(frames),
        runs=runs, launches=totals)
    emit(phase, **report)
    return report


# The tools phase: the eval/utils layer on eval_cli's outputs.
TOOLS_DIR = CLI_DIR / "tools"
TOOLS_GRID_N = 48          # the density grid of the card-against-CPU check
TOOLS_GRID_TOL = (1e-3, 5e-4)  # rtol, atol: the port-against-JAX test's on the CPU
TOOLS_ISO_PERCENTILE = 90  # of the card's grid: a level set inside the box
TOOLS_PROFILE_FACTOR = 16  # cli.test at 30x40: one chunk per rendered test image
TOOLS_AVI_FRAMES = 5000    # orbit frames cycled past one 1 GiB RIFF at 240x320
TOOLS_METRIC_TOL = 1e-6


def trace_kernels(path: Path) -> list[str]:
    """The names of the device kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def pdf_counts(path: Path) -> tuple[int, list[np.ndarray]]:
    """(pages, the embedded images in file order) of a utils/pdf file."""
    import zlib

    data = path.read_bytes()
    pages = int(re.search(rb"/Type /Pages /Kids \[[^\]]*\] /Count (\d+)", data).group(1))
    images = []
    for m in re.finditer(rb"/Subtype /Image /Width (\d+) /Height (\d+) .*?/Length (\d+) "
                         rb">>\nstream\n", data):
        w, h, n = (int(g) for g in m.groups())
        images.append(np.frombuffer(zlib.decompress(data[m.end():m.end() + n]),
                                    np.uint8).reshape(h, w, 3))
    return pages, images


def tools_phase(kernels, card: str, eval_report: dict, device="cuda") -> dict:
    """The eval/utils layer on eval_cli's outputs; see the module
    docstring for its gates."""
    phase = "tools"
    device = torch.device(device)
    phase_t0 = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    testdir = CLI_DIR / "logs_eval" / "train_cli" / f"testset_{CLI_N_ITER:06d}"
    gtdir = CLI_DIR / "scene" / "test"
    seconds, report = {}, {"card": card}

    def timed(name, fn, *args, **kwargs):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    # compare: calculate_metrics on the card against batch_metrics on the
    # same decoded PNG pairs, and against the CPU's
    metrics = timed("calculate_metrics", compare.calculate_metrics, str(testdir), str(gtdir),
                    CLI_TEST_IMAGES, device=device)
    # the test CLI renders every testskip-th test image: the pairs that exist
    names = [(testdir / f"rgb_{i:03d}.png", gtdir / f"{i + 1}.png")
             for i in range(CLI_TEST_IMAGES) if (testdir / f"rgb_{i:03d}.png").exists()]
    pairs = [native_loader.batch_load_png_rgb([str(p) for p in col], TRAIN_H, TRAIN_W)
             for col in zip(*names)]
    direct = batch_metrics(*pairs, device=device)
    on_cpu = compare.calculate_metrics(str(testdir), str(gtdir), CLI_TEST_IMAGES, device="cpu")
    for k in ("psnr", "ssim", "mse"):
        if not abs(metrics[k] - direct[k]) <= TOOLS_METRIC_TOL:
            fail(phase, f"calculate_metrics {k} {metrics[k]} against batch_metrics' "
                 f"{direct[k]} on the same PNGs")
    report["metrics"] = metrics
    report["metrics_minus_cpu"] = {k: metrics[k] - on_cpu[k] for k in metrics}
    # eval_cli scores the float render of image 0; the PNGs hold its 8-bit truncation
    report["eval_cli_float_render"] = {k: eval_report[k] for k in ("psnr", "ssim")}
    results = TOOLS_DIR / "results" / "scene"
    results.mkdir(parents=True)
    (results / "eval").symlink_to(testdir)
    rows = timed("error_calculator", compare.error_calculator, ["scene"], ["eval"],
                 str(TOOLS_DIR / "results"), str(CLI_DIR), n_images=CLI_TEST_IMAGES,
                 out_csv=str(TOOLS_DIR / "errors.csv"), device=device)
    image_row = next(r for r in rows if r["target"] == "image")
    if any(image_row[k] != metrics[k] for k in ("psnr", "ssim", "mse")):
        fail(phase, f"error_calculator's image row {image_row} against {metrics}")
    report["latex_psnr"] = compare.pprint_latex(rows)
    report["time_rows"] = compare.time_calculator([str(CLI_DIR / "logs" / "train_cli")],
                                                  str(TOOLS_DIR / "times.csv"))
    csv_lines = (TOOLS_DIR / "errors.csv").read_text().splitlines()
    if len(csv_lines) != 1 + len(rows) or len(report["time_rows"]) != 1:
        fail(phase, f"errors.csv holds {len(csv_lines)} lines for {len(rows)} rows, "
             f"{len(report['time_rows'])} time rows")

    # visualize: two experiments (the eval and the training run's test-set
    # renders) and the ground truth; one scene, then a report of two
    figs = TOOLS_DIR / "figs"
    for scene in ("scene", "scene2"):
        (figs / scene).mkdir(parents=True)
        (figs / scene / "eval").symlink_to(CLI_DIR / "logs_eval" / "train_cli")
        (figs / scene / "train").symlink_to(CLI_DIR / "logs" / "train_cli")
    targets = list(visualize.DEFAULT_COMPARE_TARGETS)
    want = []
    for exp in ("gt", "eval", "train"):
        for t in targets:
            if exp == "gt":
                path = gtdir / f"1{'' if t == 'rgb' else '_' + t}.png"
            else:
                path = figs / "scene" / exp / f"testset_{CLI_N_ITER:06d}" / f"{t}_000.png"
            if path.exists():
                want.append(path)
    pdf = Path(timed("visualize_comparison", visualize.visualize_comparison, str(figs), "scene",
                     index=0, exp_names=["eval", "train"], gt_dir=str(gtdir),
                     out_dir=str(TOOLS_DIR)))
    pages, images = pdf_counts(pdf)
    first = native_loader.batch_load_png_rgb([str(want[0])], TRAIN_H, TRAIN_W)[0]
    if pages != 1 or len(images) != len(want) or not np.array_equal(
            images[0], np.rint(first * 255).astype(np.uint8)):
        fail(phase, f"{pdf.name}: {pages} pages, {len(images)} images; expected 1 page and "
             f"{len(want)} images, the first {want[0].name}'s pixels")
    merged = Path(timed("comparison_report", visualize.comparison_report, str(figs),
                        ["scene", "scene2"], str(TOOLS_DIR / "report.pdf"), index=0,
                        exp_names=["eval", "train"], gt_dir=str(gtdir)))
    r_pages, r_images = pdf_counts(merged)
    if r_pages != 2 or len(r_images) != 2 * len(want):
        fail(phase, f"report.pdf: {r_pages} pages, {len(r_images)} images; expected 2 and "
             f"{2 * len(want)}")
    report["pdf"] = {"pages": pages, "images": len(images), "bytes": pdf.stat().st_size,
                     "report_pages": r_pages, "report_images": len(r_images),
                     "report_bytes": merged.stat().st_size}

    # profile_trace around cli.test at 30x40: the trace names K1's and K2's symbols
    zero_launch_counts()
    with timing.profile_trace(str(TOOLS_DIR / "trace"), device=device):
        t0 = time.perf_counter()
        cli_test.main(eval_argv("--render_factor", str(TOOLS_PROFILE_FACTOR),
                                "--export_basedir", str(TOOLS_DIR / "profiled")),
                      device=device)
        seconds["profiled_test"] = time.perf_counter() - t0
    launches = {k: v for k, v in _launch_counts().items() if v}
    want_launches = {"fused_field_apply": len(names), "fused_field_apply_reflected": len(names),
                     "fused_field_train_fwd_nores": len(names)}
    names_in_trace = trace_kernels(TOOLS_DIR / "trace" / timing.TRACE_NAME)
    seen = {sym: sum(sym in n for n in names_in_trace)
            for sym in ("fused_field_kernel", "k2_forward")}
    if launches != want_launches or list(seen.values()) != [len(names)] * 2:
        fail(phase, f"profiled cli.test launched {launches} (expected {want_launches}); "
             f"the trace names {seen}")
    for row in kernels:
        row.setdefault("launches_by_phase", {})[phase] = launches.get(row["name"], 0)
    report["trace"] = {"kernel_events": len(names_in_trace), "own_kernels": seen,
                       "bytes": (TOOLS_DIR / "trace" / timing.TRACE_NAME).stat().st_size}

    # video: the orbit's frames as .mp4, and cycled past one 1 GiB RIFF as AVI
    orbit, _, _ = read_avi(CLI_DIR / "logs" / "train_cli" / f"orbit_{CLI_N_ITER:06d}" / "rgb.avi")
    mp4 = Path(timed("mp4_write", video_mod.write_mp4, str(TOOLS_DIR / "orbit.mp4"), orbit))
    got, fps = read_mp4(mp4)
    if fps != 30.0 or not np.array_equal(got, orbit):
        fail(phase, f"orbit.mp4 at {fps} fps does not hold the orbit's {len(orbit)} frames")
    n_avi = TOOLS_AVI_FRAMES
    long = np.resize(orbit, (n_avi,) + orbit.shape[1:])  # the orbit's frames, cycled
    avi = TOOLS_DIR / "long.avi"
    report["avi_limit"] = video_mod.AVI_LIMIT
    timed("avi_write", video_mod.write_avi, str(avi), long)
    avi_bytes = avi.stat().st_size
    t0 = time.perf_counter()
    got, fps, counts = read_avi(avi)
    read_s = time.perf_counter() - t0
    first_riff = counts["avih"]
    if (fps != 30.0 or len(counts["riffs"]) < 2 or counts["riffs"][0] != "AVI "
            or counts["strh"] != n_avi or counts["dmlh"] != n_avi or not 0 < first_riff < n_avi
            or not np.array_equal(got, long)):
        fail(phase, f"long.avi: {got.shape} at {fps} fps, counts {counts}")
    avi.unlink()
    report["video"] = {"mp4_frames": len(orbit), "mp4_bytes": mp4.stat().st_size,
                       "avi_frames": n_avi, "avi_bytes": avi_bytes, "avi_riffs": counts["riffs"],
                       "avi_first_riff_frames": first_riff, "avi_read_s": read_s,
                       "frame_size": list(orbit.shape[1:3])}

    # a non-empty mesh: the card's density grid of the 30-update field
    # against the CPU's, then marching cubes at a level the field crosses
    args = parse_with_includes(eval_argv())
    fcfg = loop_mod.field_config_from_args(args)
    fine = {}
    for d in (device, torch.device("cpu")):
        state, _, _ = cli_test.restore_for_eval(args, fcfg, d, loop_mod.loss_config_from_args(args))
        fine[d.type] = state.variables["fine"]
    radius = 1.5
    grid = timed("density_grid", mesh_extract.query_density_grid, fine[device.type], fcfg,
                 n=TOOLS_GRID_N, radius=radius)
    grid_cpu = mesh_extract.query_density_grid(fine["cpu"], fcfg, n=TOOLS_GRID_N, radius=radius)
    rtol, atol = TOOLS_GRID_TOL
    grid_err = float(np.abs(grid - grid_cpu).max())
    if not np.allclose(grid, grid_cpu, rtol=rtol, atol=atol):
        fail(phase, f"density grid: card against CPU up to {grid_err}")
    iso = float(np.percentile(grid, TOOLS_ISO_PERCENTILE))
    obj = TOOLS_DIR / "mesh.obj"
    timed("extract_mesh", mesh_extract.extract_mesh, fine[device.type], fcfg, str(obj),
          n=TOOLS_GRID_N, radius=radius, iso=iso)
    lines = obj.read_text().splitlines()
    n_verts = sum(ln.startswith("v ") for ln in lines)
    n_faces = sum(ln.startswith("f ") for ln in lines)
    cpu_verts, _ = mesh_extract.marching_cubes(grid_cpu, iso)
    if n_verts == 0 or n_faces == 0:
        fail(phase, f"the mesh at iso {iso} is empty")
    report["mesh"] = {"n": TOOLS_GRID_N, "radius": radius, "grid_max_abs_err": grid_err,
                      "grid_range": [float(grid.min()), float(grid.max())], "iso": iso,
                      "vertices": n_verts, "faces": n_faces, "cpu_vertices": len(cpu_verts)}
    report["seconds"] = seconds
    report["phase_s"] = time.perf_counter() - phase_t0
    emit(phase, **report)
    return report


def zero_launch_counts() -> None:
    for c in (ff.LAUNCHES, fft.LAUNCHES):
        for k in c:
            c[k] = 0


@contextlib.contextmanager
def k1_full_points(points: list):
    """Within the block, the point count of every K1 full launch at f32
    (or f64) weights is appended to `points`."""
    original = ff._launch

    def launch(packed, x, cfg, density_only, *heads):
        if not density_only:
            points.append(x.shape[0])
        return original(packed, x, cfg, density_only, *heads)

    ff._launch = launch
    try:
        yield
    finally:
        ff._launch = original


def aux_argv(n_iter: int, *extra) -> list[str]:
    """train_cli's flags (later flags win) with every aux head and the
    environment map, AUX_RAYS rays, both aux losses from CLI_SWITCH on, a
    checkpoint at AUX_N_ITER, no test-set render, scalars every update."""
    return cli_argv(n_iter) + [
        "--expname", "aux_cli", "--N_rand", str(AUX_RAYS),
        "--N_iter_ignore_normal", str(CLI_SWITCH), "--N_iter_ignore_depth", str(CLI_SWITCH),
        "--i_weights", str(AUX_N_ITER), "--i_testset", "1000000", "--summary_step", "1",
        *AUX_FLAGS, *extra]


def _same(a: list, b: list) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def aux_cli_phase(kernels, card: str) -> dict:
    """The aux heads and Monte-Carlo shading through the CLIs, on
    train_cli's scene; see the module docstring for its gates."""
    phase = "aux_cli"
    logdir = CLI_DIR / "logs" / "aux_cli"
    shutil.rmtree(logdir, ignore_errors=True)
    totals = {k: 0 for k in _launch_counts()}

    def add_totals():
        for k, v in _launch_counts().items():
            totals[k] += v

    # 1. training with every aux head: the switch at CLI_SWITCH
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    first = {}
    t0 = time.perf_counter()
    with cli_probes(first, snapshot_at=(0, CLI_SWITCH)):
        state = cli_train.main(aux_argv(AUX_N_ITER))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    add_totals()
    steps, updates = first["steps"], first["updates"]
    if updates != list(range(AUX_N_ITER + 1)) or state.step != AUX_N_ITER + 1:
        fail(phase, f"updates {updates[:3]}...{updates[-3:]}, step {state.step}: "
             f"expected 0..{AUX_N_ITER}")
    for e, i in zip(steps, updates):
        # K2/K3 on both passes' primary march; past the switch K1 full on
        # both reflected marches; the aux heads and the depth-volume pass eager
        k1 = 2 if i >= CLI_SWITCH else 0
        want = {"fused_field_train_fwd": 2, "fused_field_train_bwd": 2,
                "fused_field_apply": k1, "fused_field_apply_reflected": k1}
        got = {k: v for k, v in e["launches"].items() if v}
        if got != {k: v for k, v in want.items() if v}:
            fail(phase, f"update {i} launched {got}, expected {want}")
    records = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    at_switch = {k: [r[k] for r in records if r["step"] in (CLI_SWITCH - 1, CLI_SWITCH)]
                 for k in ("loss_inferred_normal", "loss_depth", "loss_render")}
    for r in records:
        losses = {k: v for k, v in r.items() if k.startswith("loss_")}
        if not all(np.isfinite(v) for v in losses.values()):
            fail(phase, f"update {r['step']}: losses {losses}")
        for k in ("loss_inferred_normal", "loss_depth"):
            if (r[k] > 0) != (r["step"] >= CLI_SWITCH):
                fail(phase, f"update {r['step']}: {k} = {r[k]}, expected 0 before update "
                     f"{CLI_SWITCH} and above 0 from it")
    if [r["step"] for r in records] != updates:
        fail(phase, f"metrics.jsonl holds updates {[r['step'] for r in records]}")
    before = first["params_before"]
    final = {name: _leaves(v) for name, v in state.variables.items()}
    for name in AUX_TRAINED:
        if not _same(before[0][name], before[CLI_SWITCH][name]):
            fail(phase, f"{name} moved before its start, update {CLI_SWITCH}")
        if _same(before[CLI_SWITCH][name], final[name]):
            fail(phase, f"{name} did not move from update {CLI_SWITCH} on")
    for name in AUX_UNREAD:
        if not _same(before[0][name], final[name]):
            fail(phase, f"{name} moved, though no renderer reads it")

    # 2. a resume under Monte-Carlo shading: every pass shades, and the
    # training passes are two (coarse and fine), so 2 K1 full launches an
    # update, each the incident march of AUX_RAYS x MC_DIRS rays
    zero_launch_counts()
    second, mc_points = {}, []
    with cli_probes(second), k1_full_points(mc_points):
        resumed = cli_train.main(aux_argv(AUX_MC_N_ITER, "--shading_mode", "monte_carlo"))
    torch.cuda.synchronize()
    add_totals()
    mc_updates = list(range(AUX_N_ITER + 1, AUX_MC_N_ITER + 1))
    if second["updates"] != mc_updates or resumed.step != AUX_MC_N_ITER + 1:
        fail(phase, f"the Monte-Carlo resume ran updates {second['updates']} to step "
             f"{resumed.step}; expected {mc_updates}")
    for e, i in zip(second["steps"], second["updates"]):
        want = {"fused_field_train_fwd": 2, "fused_field_train_bwd": 2, "fused_field_apply": 2,
                "fused_field_apply_incident": 2}
        if {k: v for k, v in e["launches"].items() if v} != want:
            fail(phase, f"Monte-Carlo update {i} launched {e['launches']}, expected {want}")
    mc_pts = AUX_RAYS * MC_DIRS * K1_MC_SHAPE[1]
    if mc_points != [mc_pts] * (2 * len(mc_updates)):
        fail(phase, f"Monte-Carlo K1 full launches at {mc_points} points, expected "
             f"{2 * len(mc_updates)} at {mc_pts}")
    mc_losses = [r["loss_total"] for r in map(json.loads, open(logdir / "metrics.jsonl"))
                 if r["step"] > AUX_N_ITER]
    if len(mc_losses) != len(mc_updates) or not np.all(np.isfinite(mc_losses)):
        fail(phase, f"Monte-Carlo losses {mc_losses}")

    # 3. cli.test on ckpt AUX_N_ITER: Monte-Carlo shading, the inferred normal
    zero_launch_counts()
    h, w = TRAIN_H // AUX_FACTOR, TRAIN_W // AUX_FACTOR
    n_chunks = -(-h * w // CLI_CHUNK)
    timed, test_points = {}, []
    export = CLI_DIR / "eval_aux"
    test_argv = eval_argv(
        "--expname", "aux_cli", *AUX_FLAGS, "--shading_mode", "monte_carlo",
        "--calculating_normal_type", "inferred_normal_map",
        "--render_factor", str(AUX_FACTOR), "--target_load_N_iter", str(AUX_N_ITER),
        "--export_basedir", str(export))
    t0 = time.perf_counter()
    with eval_probes(timed), k1_full_points(test_points):
        results = cli_test.main(test_argv)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = {k: v for k, v in _launch_counts().items() if v}
    add_totals()
    # per chunk: the fine pass's primary march on K2 (without residual
    # stores) and its incident march on K1 full; the coarse pass
    # density-only, no ε sweep
    want = {"fused_field_apply": n_chunks, "fused_field_apply_incident": n_chunks,
            "fused_field_train_fwd_nores": n_chunks}
    if test_launches != want:
        fail(phase, f"cli.test launched {test_launches}, expected {want}")
    if test_points != [CHUNK * MC_DIRS * K1_MC_SHAPE[1]] * n_chunks:
        fail(phase, f"cli.test's K1 full launches at {sorted(set(test_points))} points")
    for k, v in results.items():
        if v.shape[:3] != (1, h, w) or not np.isfinite(v).all():
            fail(phase, f"cli.test buffer {k}: shape {v.shape} or non-finite values")
    testdir = export / "aux_cli" / f"testset_{AUX_N_ITER:06d}"
    for name in ("inferred_normal_map", "inferred_disp", "rgb"):
        png = testdir / f"{name}_000.png"
        if not png.exists() or native_loader.probe_png(str(png))[:2] != (h, w):
            fail(phase, f"{png} missing or not {h}x{w}")
    if {"reflected_radiance", "prefiltered_reflected"} & set(results):
        fail(phase, "Monte-Carlo shading exported a reflected or prefiltered buffer")
    # the same call once more under torch.profiler: where an image's time goes
    test_profile = profile_steps(lambda: cli_test.main(test_argv), n=1)

    for row in kernels:
        row.setdefault("launches_by_phase", {})[phase] = totals.get(row["name"], 0)
    n_updates = AUX_N_ITER + 1
    report = dict(
        card=card, rays=AUX_RAYS, height=TRAIN_H, width=TRAIN_W, heads=list(AUX_TRAINED),
        run_s=run_s, updates=n_updates,
        before_switch=_per_step(steps, updates, 2, CLI_SWITCH, AUX_RAYS),
        after_switch=_per_step(steps, updates, CLI_SWITCH + 2, n_updates, AUX_RAYS),
        monte_carlo=_per_step(second["steps"], second["updates"], AUX_N_ITER + 1,
                              AUX_MC_N_ITER + 1, AUX_RAYS),
        peak_memory_bytes=peak,
        losses_at_switch=at_switch, monte_carlo_losses=mc_losses,
        mc_k1_points=mc_pts, test_k1_points=CHUNK * MC_DIRS * K1_MC_SHAPE[1],
        test_size=[h, w], test_chunks=n_chunks, test_s_per_image=timed["render"][0],
        test_run_s=test_s, test_launches=test_launches, buffers=sorted(results),
        launches=totals, test_profile=test_profile,
        profile={"update": CLI_PROFILED, **first.get("profile", {})})
    emit(phase, **report)
    return report


# The flags_dp phase: the trainer's last flags and data parallelism on
# train_cli's scene. (1) cli.train with patch sampling, raw-σ noise, a
# ported init (a reference-layout .tar) and --mesh_devices 2 (one card:
# clamped, unsharded) at the CLI's 4096 rays: FLAGS_DEAD_N_ITER + 1
# updates from an init whose fine σ bias is -100, then FLAGS_N_ITER + 1
# from a live one (`patch_leg`). (2) make_sharded_train_step over two
# shards of cuda:0 against the unsharded step on the same draws for
# MESH_UPDATES updates: the loss of each within MESH_LOSS_REL, and each
# param group's move from the start within MESH_PARAM_REL of the
# unsharded one's (same kernels; the shards sum the loss's means and
# K3's dW in another order, and Adam turns that into up to lr on
# elements whose gradient is near 0). (3) `--num_processes 2` through
# cli.train in two processes on the one card over gloo (NCCL takes one
# rank per GPU), and a 1-rank NCCL group; each leg in processes of its
# own with a timeout of its own.
FLAGS_N_ITER, FLAGS_DEAD_N_ITER, FLAGS_DEAD_BIAS = 15, 1, -100.0
FLAGS_PROFILED = 13  # the live run's update under torch.profiler
MESH_UPDATES, MESH_LOSS_REL, MESH_PARAM_REL = 3, 1e-4, 1e-2
DP_N_ITER, DP_SWITCH, DP_TIMEOUT = 5, 2, 300
DP_LEGS = (("dp_gloo", "gloo", 2), ("dp_nccl", "nccl", 1))  # (name, backend, processes)


def reference_state_dict(params: dict) -> dict:
    """A port field's params under the reference's key names, Linear
    weights (out, in), on the CPU."""
    names = {"sigma": "sigma_linear", "albedo_feat": "albedo_feature_linear",
             "albedo": "albedo_linear", "roughness": "roughness_linear",
             "irradiance_feat": "irradiance_feature_linear", "irradiance": "irradiance_linear",
             "feature": "feature_linear", "radiance": "radiance_linear"}
    lin = {f"positions_linears.{i}": q for i, q in enumerate(params["trunk"])}
    lin.update({v: params[k] for k, v in names.items()})
    lin["views_linears.0"] = params["views"][0]
    for i in range(len(params["coarse"])):
        lin[f"additional_radiance_feature_linear.{i}"] = params["coarse_feat"][i]
        lin[f"additional_radiance_linear.{i}"] = params["coarse"][i]
    sd = {}
    for name, q in lin.items():
        sd[f"{name}.weight"] = q["w"].detach().T.contiguous().cpu()
        sd[f"{name}.bias"] = q["b"].detach().cpu().clone()
    return sd


def write_port_init(path: Path, cfg: FieldConfig, fine_bias: float) -> dict:
    """A reference .tar from a seed: the coarse field alive (σ bias +0.5),
    the fine one's σ bias shifted by `fine_bias`. Returns the fields."""
    rng = np.random.default_rng(SEED + 7)
    fields = {"coarse": init_field_params(rng, cfg, "cpu"), "fine": init_field_params(rng, cfg, "cpu")}
    fields["coarse"]["sigma"]["b"] += 0.5
    fields["fine"]["sigma"]["b"] += fine_bias
    torch.save({"network_fn_state_dict": reference_state_dict(fields["coarse"]),
                "network_fine_state_dict": reference_state_dict(fields["fine"]),
                "global_step": 0}, path)
    return fields


@contextlib.contextmanager
def captured_log(name: str, records: list):
    """Within the block, the messages of logger `name` go to `records`."""
    import logging

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.levelname, record.getMessage()))

    handler = Keep()
    logger = load_logger(name)
    logger.addHandler(handler)
    try:
        yield
    finally:
        logger.removeHandler(handler)


def flags_argv(expname: str, tar: Path, n_iter: int) -> list[str]:
    return cli_argv(n_iter) + [
        "--expname", expname, "--ray_sample", "patch", "--no_batching",
        "--raw_noise_std", "1.0", "--init_port_path", str(tar), "--mesh_devices", "2",
        "--i_weights", str(n_iter), "--i_testset", "1000000", "--summary_step", "1"]


def patch_leg(cfg: FieldConfig, dead: bool) -> dict:
    """(1) cli.train with patch sampling, noise, a ported init and
    --mesh_devices 2. `dead`: the ported fine field is dead (σ bias
    FLAGS_DEAD_BIAS) for FLAGS_DEAD_N_ITER + 1 updates: it must arrive
    bit for bit, be logged as dead and stay below FLAGS_DEAD_BIAS + 1
    (never re-drawn); a dead fine field gives every ray depth 0, so the
    neighbour depths' smoothness is 0. Otherwise both fields are alive,
    for FLAGS_N_ITER + 1 updates: the smoothness must be above 0, the
    kernels launch as in train_cli, and the update is timed."""
    phase = "flags_dp"
    name = "flags_dead" if dead else "flags_dp"
    n_iter = FLAGS_DEAD_N_ITER if dead else FLAGS_N_ITER
    logdir = CLI_DIR / "logs" / name
    shutil.rmtree(logdir, ignore_errors=True)
    tar = CLI_DIR / f"{name}_init.tar"
    fields = write_port_init(tar, cfg, FLAGS_DEAD_BIAS if dead else 0.5)
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    record, logs = {}, []
    t0 = time.perf_counter()
    with (cli_probes(record, snapshot_at=(0, 1), profiled=-1 if dead else FLAGS_PROFILED),
          captured_log("train", logs)):
        state = cli_train.main(flags_argv(name, tar, n_iter))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _launch_counts()
    steps, updates = record["steps"], record["updates"]
    if updates != list(range(n_iter + 1)) or state.step != n_iter + 1:
        fail(phase, f"{name}: updates {updates[:3]}...{updates[-3:]}, step {state.step}")
    before = {i: {g: dict(zip([n for n, _ in _named(state.variables[g])], leaves))
                  for g, leaves in by_group.items()}
              for i, by_group in record["params_before"].items()}
    for g in ("coarse", "fine"):
        want = dict(_named(fields[g]))
        if set(want) != set(before[0][g]) or not all(
                torch.equal(before[0][g][n].cpu(), t) for n, t in want.items()):
            fail(phase, f"{name}: the ported {g} field did not arrive bit for bit")
    dead_log = [m for level, m in logs if level == "ERROR" and "field init is DEAD" in m]
    records = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    losses = [r["loss_total"] for r in records]
    smooth = [r["patch_depth_smoothness"] for r in records]
    if len(records) != n_iter + 1 or not np.all(np.isfinite(losses + smooth)):
        fail(phase, f"{name}: losses {losses}, patch_depth_smoothness {smooth}")
    if dead:
        # after the first update, and after the last
        fine_bias = [float(before[1]["fine"]["sigma.b"].max()),
                     float(state.variables["fine"]["sigma"]["b"].detach().max())]
        if max(fine_bias) >= FLAGS_DEAD_BIAS + 1 or len(dead_log) != 1 or "fine" not in dead_log[0]:
            fail(phase, f"{name}: fine σ bias {fine_bias}, dead-init log {dead_log}: the "
                 f"dead init was re-drawn or not reported")
        return dict(updates=n_iter + 1, run_s=run_s, fine_sigma_bias_max=fine_bias,
                    dead_init_log=dead_log[0], losses=losses, patch_depth_smoothness=smooth)
    for e, i in zip(steps, updates):
        k1 = 2 if i >= CLI_SWITCH else 0
        want = {"fused_field_train_fwd": 2, "fused_field_train_bwd": 2,
                "fused_field_apply": k1, "fused_field_apply_reflected": k1}
        if {k: v for k, v in e["launches"].items() if v} != {k: v for k, v in want.items() if v}:
            fail(phase, f"{name}: update {i} launched {e['launches']}, expected {want}")
    clamp = [m for _, m in logs if m.startswith("--mesh_devices 2")]
    if dead_log or not clamp or not all(v > 0 for v in smooth):
        fail(phase, f"{name}: dead-init log {dead_log}, mesh clamp log {clamp}, "
             f"patch_depth_smoothness {smooth}")
    return dict(
        updates=n_iter + 1, rays=CLI_RAYS, neighbour_rays=8 * CLI_RAYS, run_s=run_s,
        before_switch=_per_step(steps, updates, 2, CLI_SWITCH),
        after_switch=_per_step(steps, updates, CLI_SWITCH + 2, n_iter + 1),
        peak_memory_bytes=peak, launches=launches, losses=losses,
        patch_depth_smoothness=smooth, mesh_clamp_log=clamp[0],
        profile={"update": FLAGS_PROFILED, **record.get("profile", {})})


def _named(tree, prefix=""):
    """(dotted name, leaf) pairs of a param tree, in _leaves order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _named(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _named(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def mesh_leg(cfg: FieldConfig, consts: dict, device) -> dict:
    """(2) make_sharded_train_step over two shards of cuda:0 against the
    unsharded step, the CLI's update (4096 rays, gt normals, merged
    sampling, bf16_grad, K2/K3 and K1 full)."""
    phase = "flags_dp"
    rcfg, lcfg, tphase = train_config(cfg, normal_type="ground_truth")
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    arrays = train_scene(device, gen)
    arrays["normal"] = torch.rand(arrays["images"].shape, device=device, generator=gen)
    rng = np.random.default_rng(SEED + 11)
    start = {"coarse": init_field_params(rng, cfg, device), "fine": init_field_params(rng, cfg, device)}
    for v in start.values():
        v["sigma"]["b"] += 0.5
    runs = {}
    for name in ("unsharded", "mesh"):
        optimizer = build_optimizer(start, lrate=5e-4, lrate_decay=250, lcfg=lcfg)
        state = init_train_state(start, optimizer)
        kw = dict(merged_sampling=True)
        if name == "mesh":
            step, place_state, _ = make_sharded_train_step(
                rcfg, lcfg, tphase, optimizer, consts, TRAIN_H, TRAIN_W, CLI_RAYS, 0.7, 2.0,
                6.0, [device, device], **kw)
            state = place_state(state)
        else:
            step = make_train_step(rcfg, lcfg, tphase, optimizer, consts, TRAIN_H, TRAIN_W,
                                   CLI_RAYS, 0.7, 2.0, 6.0, **kw)
        runs[name] = {"step": step, "state": state, "losses": [], "ms": []}
    zero_launch_counts()
    for i in range(MESH_UPDATES):
        draws = runs["unsharded"]["step"].draw(
            arrays, torch.Generator(device=device).manual_seed(100 + i))
        for run in runs.values():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run["state"], sc = run["step"](run["state"], arrays, draws=draws)
            torch.cuda.synchronize()
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            run["losses"].append(float(sc["loss_total"]))
    launches = _launch_counts()
    ref, got = runs["unsharded"], runs["mesh"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    param_rel = {}
    for group in start:
        s0 = flat_grads(start[group])
        moved_ref = flat_grads(ref["state"].variables[group]).detach() - s0
        moved = flat_grads(got["state"].variables[group]).detach() - s0
        param_rel[group] = float(torch.linalg.vector_norm(moved - moved_ref)
                                 / torch.linalg.vector_norm(moved_ref))
    if (not np.all(np.isfinite(got["losses"])) or max(loss_rel) > MESH_LOSS_REL
            or max(param_rel.values()) > MESH_PARAM_REL):
        fail(phase, f"mesh against unsharded: loss rel {loss_rel}, params rel {param_rel}")
    # per update: each shard runs both passes' K2/K3 and K1 full
    want = {"fused_field_train_fwd": 6 * MESH_UPDATES, "fused_field_train_bwd": 6 * MESH_UPDATES,
            "fused_field_apply": 6 * MESH_UPDATES,
            "fused_field_apply_reflected": 6 * MESH_UPDATES}
    if {k: v for k, v in launches.items() if v} != want:
        fail(phase, f"mesh leg launched {launches}, expected {want}")
    return dict(shards=2, rays=CLI_RAYS, updates=MESH_UPDATES, losses=ref["losses"],
                mesh_losses=got["losses"], loss_rel=loss_rel, param_rel=param_rel,
                ms_unsharded=ref["ms"], ms_mesh=got["ms"], launches=launches,
                bounds={"loss_rel": MESH_LOSS_REL, "param_rel": MESH_PARAM_REL})


def dp_command(spec: dict) -> list[str]:
    """The command line of one data-parallel worker process."""
    return [sys.executable, str(Path(__file__).resolve()), "dp_worker", json.dumps(spec)]


def dp_argv(expname: str, world: int, rank: int, port: int) -> list[str]:
    return cli_argv(DP_N_ITER) + [
        "--expname", expname, "--N_iter_ignore_approximated_radiance", str(DP_SWITCH),
        "--i_weights", str(DP_N_ITER), "--i_testset", "1000000", "--summary_step", "1",
        "--num_processes", str(world), "--coordinator_address", f"localhost:{port}",
        "--process_id", str(rank)]


def dp_worker(spec: dict) -> int:
    """One rank of a data-parallel leg: cli.train.main over gloo (2
    ranks) or inside a 1-rank NCCL group, every file this process opens
    for writing recorded, each update and its all_reduce timed; the
    final params, the writes and the times go to spec["out"]."""
    import builtins

    import torch.distributed as dist

    from ibl_nerf_tpu_torch.parallel import distributed
    from ibl_nerf_tpu_torch.train import checkpoint

    writes, update_ms, reduce_ms = [], [], []
    real_open, real_makedirs, real_write = builtins.open, os.makedirs, checkpoint._write
    real_call, real_reduce = distributed.GlobalTrainStep.__call__, distributed.GlobalTrainStep.all_reduce

    def spy_open(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax+"):
            writes.append(str(file))
        return real_open(file, mode, *a, **kw)

    def spy_makedirs(name, *a, **kw):
        writes.append(str(name))
        return real_makedirs(name, *a, **kw)

    def spy_write(path, *a, **kw):
        writes.append(str(path))
        return real_write(path, *a, **kw)

    def timed(fn, out):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*a, **kw)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            return result
        return run

    builtins.open, os.makedirs, checkpoint._write = spy_open, spy_makedirs, spy_write
    distributed.GlobalTrainStep.__call__ = timed(real_call, update_ms)
    distributed.GlobalTrainStep.all_reduce = timed(real_reduce, reduce_ms)
    if spec["world"] == 1:  # cli.train joins no group for one process: join it here
        dist.init_process_group(spec["backend"], init_method=f"tcp://localhost:{spec['port']}",
                                world_size=1, rank=0)
    state = cli_train.main(spec["argv"], backend=spec["backend"])
    backend = dist.get_backend()
    builtins.open, os.makedirs, checkpoint._write = real_open, real_makedirs, real_write
    torch.save({"variables": {k: _map_tree(lambda p: p.detach().cpu(), v)
                              for k, v in state.variables.items()},
                "step": state.step, "backend": backend, "update_ms": update_ms,
                "reduce_ms": reduce_ms, "launches": _launch_counts(),
                "writes": [w for w in writes if str(CLI_DIR / "logs") in os.path.abspath(w)]},
               spec["out"])
    dist.destroy_process_group()
    return 0


def run_dp_leg(name: str, backend: str, world: int) -> list[dict]:
    """Start `world` worker processes of one leg, wait for each within
    DP_TIMEOUT (killing all on a timeout or a failure), return their
    results in rank order."""
    shutil.rmtree(CLI_DIR / "logs" / name, ignore_errors=True)
    port = _free_port()
    outs = [CLI_DIR / f"{name}_{r}.pt" for r in range(world)]
    procs = [subprocess.Popen(dp_command({"backend": backend, "world": world, "port": port,
                                          "out": str(outs[r]),
                                          "argv": dp_argv(name, world, r, port)}),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + DP_TIMEOUT
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                fail("flags_dp", f"{name}: rank {r} did not finish in {DP_TIMEOUT} s")
            if p.returncode != 0:
                fail("flags_dp", f"{name}: rank {r} exited {p.returncode}:\n{out[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(o, weights_only=False) for o in outs]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_legs() -> dict:
    """(3) --num_processes 2 over gloo on one card, and a 1-rank NCCL
    group; gates: every loss finite, the replicas bit-identical, only
    rank 0 wrote the logdir, the last checkpoint restores to the final
    params."""
    phase = "flags_dp"
    report = {}
    for name, backend, world in DP_LEGS:
        t0 = time.perf_counter()
        results = run_dp_leg(name, backend, world)
        seconds = time.perf_counter() - t0
        logdir = CLI_DIR / "logs" / name
        r0 = results[0]
        if any(r["backend"] != backend or r["step"] != DP_N_ITER + 1 for r in results):
            fail(phase, f"{name}: backends {[r['backend'] for r in results]}, steps "
                 f"{[r['step'] for r in results]}")
        for r in results[1:]:
            for group, tree in r["variables"].items():
                if not _same(_leaves(tree), _leaves(r0["variables"][group])):
                    fail(phase, f"{name}: the {group} params differ between ranks")
            if r["writes"]:
                fail(phase, f"{name}: a rank other than 0 wrote {r['writes'][:5]}")
        losses = [json.loads(line)["loss_total"] for line in open(logdir / "metrics.jsonl")]
        if len(losses) != DP_N_ITER + 1 or not np.all(np.isfinite(losses)):
            fail(phase, f"{name}: losses {losses}")
        template = TrainState(variables=r0["variables"], opt_state={}, step=0)
        restored, _, found = ckpt_lib.restore_checkpoint(str(logdir), template)
        if not found or restored.step != DP_N_ITER + 1 or not all(
                _same([p.detach() for p in _leaves(restored.variables[g])], _leaves(tree))
                for g, tree in r0["variables"].items()):
            fail(phase, f"{name}: ckpt_{DP_N_ITER:06d} does not restore the final params")
        report[name] = dict(
            backend=backend, processes=world, rays=CLI_RAYS, rays_per_process=CLI_RAYS // world,
            updates=DP_N_ITER + 1, seconds=seconds, losses=losses,
            update_ms=[r["update_ms"] for r in results], reduce_ms=[r["reduce_ms"] for r in results],
            launches=[r["launches"] for r in results],
            rank0_files=sorted({os.path.relpath(w, logdir) for w in r0["writes"]
                                if os.path.abspath(w).startswith(str(logdir))}))
    return report


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def flags_dp_phase(kernels, cfg: FieldConfig, consts: dict, device, card: str) -> dict:
    """The trainer's last flags and data parallelism; see the comment
    above FLAGS_N_ITER and each leg for the gates."""
    phase = "flags_dp"
    report = dict(card=card, dead_port_init=patch_leg(cfg, dead=True),
                  patch_noise_port_init=patch_leg(cfg, dead=False))
    patch_launches = report["patch_noise_port_init"]["launches"]
    torch.cuda.empty_cache()
    report["mesh"] = mesh_leg(cfg, consts, device)
    torch.cuda.empty_cache()
    report.update(dp_legs())
    for row in kernels:
        row.setdefault("launches_by_phase", {})[phase] = (
            patch_launches.get(row["name"], 0) + report["mesh"]["launches"].get(row["name"], 0))
    emit(phase, **report)
    return report


# The f64 phase: compute_dtype float64 (the strict-parity mode) with K1 at
# f64 weights on the no-grad sweeps. Serving as in the slice phase; one
# chunk held to the eager f64 render (use_pallas off) within the repo's
# f32 bounds (tests/test_torch_renderer.py: atol / rtol on the basic and
# the shaded maps). Then cli.train at F64_RAYS rays for F64_N_ITER + 1
# updates across the phase switch (at 4096 rays the eager f64 gradient
# path's stored activations would near the card's memory), and cli.test
# on its last checkpoint at render factor F64_FACTOR.
F64_BASIC_TOL, F64_SHADED_TOL = (5e-4, 1e-3), (2e-3, 5e-3)
F64_SHADED = {"color_map", "specular_map", "diffuse_map", "n_dot_v_map", "target_normal_map",
              "normal_map_from_depth_gradient_epsilon",
              "normal_map_from_depth_gradient_direction_epsilon",
              "reflected_radiance_map", "prefiltered_reflected_map"}
F64_RAYS, F64_N_ITER, F64_FACTOR = 1024, 11, 4


def f64_phase(cfg, variables, consts, kernels, card: str) -> dict:
    """compute_dtype float64 with use_pallas through serving, cli.train
    and cli.test; see the module docstring for its gates."""
    phase = "f64"
    phase_t0 = time.perf_counter()
    totals = {k: 0 for k in _launch_counts()}

    def add_totals():
        for k, v in _launch_counts().items():
            totals[k] += v

    # 1. serving: one chunk against the eager f64 render, then render_path
    rcfg = serving_config(cfg, compute_dtype="float64")
    scene = Scene()
    batch = first_chunk(scene)
    out = render_rays(variables, consts, batch, rcfg)
    ref = render_rays(variables, consts, batch, rcfg.replace(use_pallas=False))
    gap = {}
    for k, r in ref.items():
        atol, rtol = F64_SHADED_TOL if k in F64_SHADED else F64_BASIC_TOL
        err = (out[k].double() - r.double()).abs()
        gap[k] = err.max().item()
        if not torch.isfinite(out[k]).all() or (err > atol + rtol * r.double().abs()).any():
            fail(phase, f"{k}: the K1-f64 render is {gap[k]:.3e} from the eager f64 render "
                 f"(atol {atol}, rtol {rtol})")
    del out, ref
    torch.cuda.empty_cache()
    events_ms = chunk_ms_events(variables, consts, batch, rcfg)
    served = serve(phase, variables, consts, scene, rcfg, kernels,
                   {"fused_field_density_f64": 1, "fused_field_apply_f64": 1})
    add_totals()
    torch.cuda.empty_cache()

    # 2. cli.train at F64_RAYS rays across the phase switch
    logdir = CLI_DIR / "logs" / "f64_cli"
    shutil.rmtree(logdir, ignore_errors=True)
    argv = [a for a in cli_argv(F64_N_ITER) if a != "--use_pallas_train"] + [
        "--expname", "f64_cli", "--compute_dtype", "float64", "--N_rand", str(F64_RAYS),
        "--i_weights", str(F64_N_ITER), "--i_testset", "1000000", "--summary_step", "1"]
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rec = {}
    t0 = time.perf_counter()
    with cli_probes(rec, profiled=-1):
        state = cli_train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    add_totals()
    steps, updates = rec["steps"], rec["updates"]
    if updates != list(range(F64_N_ITER + 1)) or state.step != F64_N_ITER + 1:
        fail(phase, f"updates {updates}, step {state.step}: expected 0..{F64_N_ITER}")
    for e, i in zip(steps, updates):
        # past the switch K1-f64 full on both passes' reflected march; the
        # gradient path eager f64, no ε sweep under gt normals
        want = {"fused_field_apply_f64": 2} if i >= CLI_SWITCH else {}
        got = {k: v for k, v in e["launches"].items() if v}
        if got != want:
            fail(phase, f"update {i} launched {got}, expected {want}")
    losses = [r["loss_total"] for r in map(json.loads, open(logdir / "metrics.jsonl"))
              if "loss_total" in r]
    if len(losses) != F64_N_ITER + 1 or not np.all(np.isfinite(losses)):
        fail(phase, f"losses {losses}")
    if not (logdir / f"ckpt_{F64_N_ITER:06d}").exists():
        fail(phase, f"no ckpt_{F64_N_ITER:06d}")
    torch.cuda.empty_cache()

    # 3. cli.test on that checkpoint at render factor F64_FACTOR
    zero_launch_counts()
    h, w = TRAIN_H // F64_FACTOR, TRAIN_W // F64_FACTOR
    timed = {}
    test_argv = [a for a in eval_argv() if a != "--use_pallas_train"] + [
        "--expname", "f64_cli", "--compute_dtype", "float64",
        "--render_factor", str(F64_FACTOR), "--export_basedir", str(CLI_DIR / "eval_f64")]
    t0 = time.perf_counter()
    with eval_probes(timed):
        results = cli_test.main(test_argv)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = {k: v for k, v in _launch_counts().items() if v}
    add_totals()
    n_images = next(iter(results.values())).shape[0]
    n_chunks = n_images * -(-h * w // CLI_CHUNK)
    # per chunk: the fine pass's primary march eager f64, its reflected
    # march on K1-f64 full; the coarse pass density-only and eager
    if test_launches != {"fused_field_apply_f64": n_chunks}:
        fail(phase, f"cli.test launched {test_launches}, expected {n_chunks} K1-f64 full "
             f"(one a chunk) and nothing else")
    for k, v in results.items():
        if v.shape[1:3] != (h, w) or not np.isfinite(v).all():
            fail(phase, f"cli.test buffer {k}: shape {v.shape} or non-finite values")

    for row in kernels:
        row.setdefault("launches_by_phase", {})[phase] = totals.get(row["name"], 0)
    report = dict(
        card=card, compute_dtype="float64", **served, chunk_ms_cuda_events=events_ms,
        chunk_vs_eager_f64_max_abs_err=gap, basic_tol=F64_BASIC_TOL,
        shaded_tol=F64_SHADED_TOL,
        train=dict(rays=F64_RAYS, updates=F64_N_ITER + 1, run_s=run_s,
                   before_switch=_per_step(steps, updates, 2, CLI_SWITCH, F64_RAYS),
                   after_switch=_per_step(steps, updates, CLI_SWITCH, F64_N_ITER + 1,
                                          F64_RAYS),
                   peak_memory_bytes=peak, losses=losses),
        test=dict(size=[h, w], images=n_images, chunks=n_chunks, seconds=test_s,
                  s_per_image=timed["render"], launches=test_launches),
        phase_s=time.perf_counter() - phase_t0)
    emit(phase, **report)
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
    native = kernel_build.build_native()  # the PNG decoder first: g++ and zlib
    native_s = time.perf_counter() - t0
    kernel_build.build()
    report = {name: [ln for ln in log.splitlines()
                     if "entry function" in ln or "registers" in ln or "spill" in ln]
              for name, log in kernel_build.build_logs.items() if name in kernel_build.SOURCES}
    emit("build", seconds=time.perf_counter() - t0, sources=list(kernel_build.SOURCES),
         native_loader=str(native.name), native_seconds=native_s, ptxas=report)

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
    kernels += k1_f64_kernel_phase(cfg, variables["fine"], gen)
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
    torch.cuda.empty_cache()
    train_cli_phase(kernels, card)
    eval_report = eval_cli_phase(kernels, card)
    tools_phase(kernels, card, eval_report)
    aux_cli_phase(kernels, card)
    torch.cuda.empty_cache()
    flags_dp_phase(kernels, cfg, consts, device, card)
    torch.cuda.empty_cache()
    f64_phase(cfg, variables, consts, kernels, card)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dp_worker"]:
        sys.exit(dp_worker(json.loads(sys.argv[2])))
    sys.exit(main())
