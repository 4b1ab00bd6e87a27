#!/usr/bin/env python3
"""K3, K2, K1 (f32 weights) or K1 at bf16 weights with one part knocked out
at a time.

    python3 k3_knockout.py                # K3, from the root of a checkout, one card
    python3 k3_knockout.py k2             # K2
    python3 k3_knockout.py k2 --parent OLD.cu
    python3 k3_knockout.py k1 --parent OLD.cu
    python3 k3_knockout.py k1bf16 --parent OLD.cu
    python3 k3_knockout.py k1f64 [--parent OLD.cu]

Builds `ibl_nerf_tpu_torch/csrc/fused_field_train.cu` as it is and once
per variant -- a text substitution that removes one part of the kernel
(K3: of `k3_delta_chain`; K2: of `k2_forward`'s body, the wgmma field
chain of `csrc/wgmma_field.cuh`, which a variant's source holds written
out in place of its include: the residual stores, the weight ring's TMA
copies, both, the wgmma products, the epilogues' stores, the sines) or
changes one setting -- all nvcc processes at once, then times the kernel
at the fine pass's point count (512 x 192) by stage (torch.profiler, as
chip_smoke.stage_ms), every variant in turn, twice; K2 also at an
update's fine pass (786,432 points) with and without its residual
stores. A variant's outputs are wrong by design (its relative error to
the intact kernel is printed to show it ran); only its time means
something: what a part costs is at most the intact kernel's time minus
the variant's. One JSON line per variant and round, then the card line.

With `--parent`, the source of an earlier K2 is built too -- its entry
point either takes the slab stream as today's does, or every weight
matrix transposed to [out][in] -- and both are held against the plain
version (raw and every residual plane within chip_smoke's
TRAIN_KERNEL_REL) at chip_smoke's six point counts, with the blocks not
bit-equal between the two counted (the run exits 1 if either fails the
gate); then the two are timed in turns (parent, new, new, parent) at the
fine pass and at the benchmark cells' K2 shapes, the new one also
without residual stores. Fails without CUDA, and when a substitution's
text is gone from the source.

K1 (`k1`) knocks parts out of `csrc/fused_field.cu` (of the full
variants' tile and of the density variant's; settings: the density lane
tile 8 x 16, its loop over pairs of k not unrolled) and times both
variants at the serving shapes (full at 2048 x 64 points, density at
4 x 2048 x 192), by CUDA events, every variant in turn, twice, with each
variant's registers and spills and the blocks an SM holds, and the SM
clock and power draw under the density variant intact and without
either load. `k1 --parent OLD.cu` takes an earlier K1 source, its entry
point with or without the projection table (e.g. `git show
<commit>:ibl_nerf_tpu_torch/csrc/fused_field.cu` into the git-ignored
`build/`): both are held against the plain version under chip_smoke's
K1 gate at ragged and main-path counts, density also within
chip_smoke's K1_DENSITY_REL at its three ε-sweep counts (the run exits 1
if either fails), then timed in turns (parent, new, new, parent) with
full at 131,072 and at the train step's 32,768 points and density at
those three counts.

K1 at bf16 weights (`k1bf16`) knocks parts out of
`csrc/fused_field_bf16.cu` and the field chain it includes (the wgmma
products, the TMA weight copies, the epilogues' stores to shared memory,
their bf16 conversions, their proxy fence, the sines; settings: a density
ring of 4 stages, no setmaxnreg, one block per tile instead of one per
SM, the constants read by __ldg) and times
both variants at the serving shapes, every variant in turn, twice, with
the registers and spills of each build and the shared memory and blocks
per SM of the intact one, and the SM clock and power nvidia-smi reads
under the density variant. `k1bf16 --parent OLD.cu` takes an earlier
`csrc/fused_field_train.cu` that held the variant (its
`fused_field_bf16_launch`, e.g. from `git show <commit>:...`): the
intact kernel and the parent are held against the plain version within
chip_smoke's TRAIN_KERNEL_REL at ragged and main-path counts (the run
exits 1 if either fails; the intact kernel also bit-identical on a
rerun), then timed in turns (parent, new, new, parent): density at
1,572,864 points, full at 131,072 and 32,768.

K1 at f64 weights (`k1f64`) builds `csrc/fused_field_f64.cu` with the
mma.sync shapes it could take (m16n8k4 as written; m8n8k4, Ampere's shape,
two to one m16n8k4; m16n8k8; m16n8k16), its k loop unrolled 1, 2 (as
written) or 4 times, with parts knocked out (the
products cut to one FMA a fragment, the weight loads, the sines) and with
the full variant's epilogue head partials, or its sums over warps, run
twice (the same values written again: the second run's time is the part's),
prints each build's registers and spills, holds the intact kernel,
every shape and setting and the run-twice variants against the plain version within
chip_smoke's K1_F64_REL, bit-identical on a rerun, with the count of
outputs not bit-equal to the plain version (the run exits 1 if one
fails), and times every variant at
the serving shapes (density at 1,572,864 points, full at 131,072) by CUDA
events, in turn, twice; the intact full variant is also held at the
Monte-Carlo march's 1,179,648 points. `k1f64 --parent OLD.cu` takes an
earlier source of the same entry points (e.g. `git show
<commit>:ibl_nerf_tpu_torch/csrc/fused_field_f64.cu` into the git-ignored
`build/`): it is held to the plain version too, its density output must
equal the intact kernel's bit for bit (the full output's equality is
reported), and the two are timed in turns (parent, new, new, parent) at
the three shapes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from ibl_nerf_tpu_torch.kernels import build as kb
from ibl_nerf_tpu_torch.kernels import fused_field as ff
from ibl_nerf_tpu_torch.kernels import fused_field_bf16 as k1b
from ibl_nerf_tpu_torch.kernels import fused_field_f64 as k1d
from ibl_nerf_tpu_torch.kernels import fused_field_train as fft
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params

MMA = ("              mma16816(acc[mt][j], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);\n"
       "              mma16816(acc[mt][j + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2], b[3]);\n",
       "")
# K1 at an eighth of its products: one FMA per loaded weight, every load kept
K1_FMA = ("        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i], b[jj], acc[i][j]);",
          "        for (int i = 0; i < 1; ++i) acc[i][j] = fmaf(a[jj + 4 * (q & 1)], b[jj], acc[i][j]);")
K1_LOADS = ("      const float4 b4 = __ldg(reinterpret_cast<const float4*>(wk + 32 * q));",
            "      const float4 b4 = make_float4(__int_as_float(0x3c000000 | (k << 3) | q), 1.f, 2.f, 3.f);")
# the same three knock-outs of the density variant's lane tile (dload, dfma):
# one FMA in 8 (each loaded operand still used), the weight loads, the
# activation loads
K1D_FMA = ("    for (int j = 0; j < kDCols; ++j) acc[i][j] = fmaf(f.a[i], f.b[j], acc[i][j]);",
           "    for (int j = 0; j < kDCols; ++j)\n"
           "      if (j == (i & (kDCols - 1))) acc[i][j] = fmaf(f.a[i], f.b[j], acc[i][j]);")
K1D_LOADS = ("    const float4 b4 = __ldg(reinterpret_cast<const float4*>(wk + 4 * kDCg * q));",
             "    const float4 b4 = make_float4(__int_as_float(0x3c000000 | (k << 3) | q), 1.f, 2.f, 3.f);")
K1D_ACT = ("        *reinterpret_cast<const float4*>(il + k * kStride + 4 * kDPg * m);",
           "        make_float4(k, m, 2.f, 3.f);")
# every epilogue projection run twice (on column c ^ 1 the second time)
K1_PROJ = ("      o[c * kStride] += s;",
           "      o[c * kStride] += s + project_col<NCOL>(v, P, n_out, c ^ 1, t);")
SLABS = ("    if (issued < total) {\n      const bf16_t* s = src",
         "    if (issued < 0) {\n      const bf16_t* s = src")
BARRIERS = ("    cp_async_wait<kRing - 2>();\n    __syncthreads();\n    issue();",
            "    issue();")
SINES = ("return __ldg(emb.id + l) > 0.f ? t : sinf(t + __ldg(emb.phase + l));",
         "return __ldg(emb.id + l) > 0.f ? t : t + __ldg(emb.phase + l);")
# knock-outs of the wgmma field chain (csrc/wgmma_field.cuh: K2, K1 at bf16)
WGMMA = ("        Wgmma<N>::mma(acc, sw64_desc(a), sw64_desc(bb), scale);\n"
         "        Wgmma<N>::mma(acc, sw64_desc(a + 32), sw64_desc(bb + 32), 1);\n",
         "")
WEIGHT_COPIES = (
    "          mbar_expect_tx(full + 8 * stage, kSlabBytes);\n"
    "          tma_load_slab(base + stage * kSlabBytes, slab_map, s * kSlabN, full + 8 * stage);\n",
    "          mbar_arrive(full + 8 * stage);\n")
STMATRIX = ('    asm volatile("stmatrix.sync.aligned',
            '    if (wg < 0) asm volatile("stmatrix.sync.aligned')
WG_SINES = ("(arg == 0.f ? arg : sinf(arg))", "arg")
RES_STORES = ("    if (!kOn || (threadIdx.x & 31)) return;", "    return;")
# the header holding the field chain, written out in a variant's source
CHAIN_HEADER = "wgmma_field.cuh"
# variant -> substitutions of the source; what each leaves out
VARIANTS = {
    "k3": {
        "intact": [],
        "no_products": [MMA],                      # the mma.sync of every layer
        "no_slab_loads": [SLABS],                  # the weight slabs' copies from L2
        "no_products_no_slab_loads": [MMA, SLABS],
        "no_slab_barriers": [BARRIERS],            # the wait and block barrier per slab
        "no_b_fragments": [("            ldsm_x4(b, slab + (nl + 8 * j + rr + 8 * (q >> 1)) * kLdSlab"
                            " + kk + 8 * (q & 1));",
                            "            b[0] = b[1] = b[2] = b[3] = j;")],
        "no_residual_masks": [("v = __ldg(reinterpret_cast<const unsigned int*>(epi.mask_g + p * kWidth + c));",
                               "v = 0x3f803f80u;")],
        "no_delta_stores": [("    store_tile(out.p[", "    if (n < 0) store_tile(out.p[")],
        "no_sines": [SINES],
        "ring_of_3": [("constexpr int kRing = 4;", "constexpr int kRing = 3;")],
        # the dW stage at one block per SM: no register cap, so no spill
        "dw_one_block_per_sm": [("__launch_bounds__(kThreads, 2)\n    k3_dw_gemm",
                                 "__launch_bounds__(kThreads, 1)\n    k3_dw_gemm")],
    },
    "k2": {
        "intact": [],
        "no_residual_stores": [RES_STORES],        # the planes' TMA bulk stores
        "no_weight_copies": [WEIGHT_COPIES],       # the weight ring's TMA copies
        "no_residual_stores_no_weight_copies": [RES_STORES, WEIGHT_COPIES],
        "no_products": [WGMMA],                    # every wgmma of the layers and heads
        "no_epilogue_stores": [STMATRIX],          # the epilogues' stores to shared memory
        "no_sines": [WG_SINES],
    },
    "k1": {
        "intact": [],
        "eighth_products": [K1_FMA, K1D_FMA],      # 1 FMA of 8 in every layer; loads kept
        "no_weight_loads": [K1_LOADS, K1D_LOADS],
        "eighth_products_no_weight_loads": [K1_FMA, K1_LOADS, K1D_FMA, K1D_LOADS],
        "projections_twice": [K1_PROJ],            # the full variant's epilogue projections
        "no_barriers": [('  asm volatile("bar.sync %0, 128;" ::"r"(quad + 1) : "memory");', "")],
        "no_sines": [("? u : sinf(u + __ldg(w.p[kEmbPhase] + l));",
                      "? u : u + __ldg(w.p[kEmbPhase] + l);")],
        "no_act_loads": [
            ("    const float4 a0 = *reinterpret_cast<const float4*>(in + k * kStride + t.prow);",
             "    const float4 a0 = make_float4(k, 1.f, 2.f, 3.f);"),
            ("        *reinterpret_cast<const float4*>(in + k * kStride + t.prow + 4);",
             "        make_float4(k, 5.f, 6.f, 7.f);"), K1D_ACT],
        # settings: the full variants' k loop unrolled 2 or 8 times instead
        # of 4; the density lane tile 8 points x 16 columns instead of 16 x
        # 8, or its loop over pairs of k not unrolled instead of twice
        "unroll_2": [("#pragma unroll 4\n  for (int k = 0;", "#pragma unroll 2\n  for (int k = 0;")],
        "unroll_8": [("#pragma unroll 4\n  for (int k = 0;", "#pragma unroll 8\n  for (int k = 0;")],
        "tile_8x16": [("constexpr int kDPts = 16;", "constexpr int kDPts = 8;")],
        "density_pairs_unroll_1": [("#pragma unroll 2\n  for (; k + 1 < k_dim; k += 2) {",
                                    "#pragma unroll 1\n  for (; k + 1 < k_dim; k += 2) {")],
    },
    "k1bf16": {
        "intact": [],
        "no_products": [WGMMA],
        "no_weight_copies": [WEIGHT_COPIES],
        "no_epilogue_stores": [STMATRIX],
        "no_epilogue_cvt": [
            ('        asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\\n" : "=r"(pk[q]) : "f"(v1), "f"(v0));\n'
             '      else\n'
             '        asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n" : "=r"(pk[q]) : "f"(v1), "f"(v0));',
             '        pk[q] = __float_as_uint(v0) ^ __float_as_uint(v1);\n'
             '      else\n'
             '        pk[q] = __float_as_uint(v1);')],
        "no_epilogue_fence": [
            ("  fence_async_smem();\n  wg_sync(wg);\n}\n\n// The residual planes'",
             "  wg_sync(wg);\n}\n\n// The residual planes'")],
        "no_sines": [WG_SINES],
        # settings: a density ring of 4 stages instead of 8; no setmaxnreg;
        # one block per tile instead of a persistent block per SM; the
        # constants read by __ldg, which the compiler may hoist
        "density_ring_4": [("return density ? 8 : 4;", "return density ? 4 : 4;")],
        "one_block_per_tile": [("n_tiles < sms ? n_tiles : sms", "n_tiles")],
        "plain_ldg": [('  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\\n"\n'
                       '               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)\n'
                       '               : "l"(p));',
                       '  v = __ldg(reinterpret_cast<const float4*>(p));'),
                      ('  asm volatile("ld.global.nc.u32 %0, [%1];\\n" : "=r"(v) : "l"(p));',
                       '  v = __ldg(reinterpret_cast<const unsigned int*>(p));'),
                      ('  asm volatile("ld.global.nc.u16 %0, [%1];\\n" : "=h"(v) : "l"(p));',
                       '  v = __ldg(p);')],
        "no_setmaxnreg": [
            ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kProducerRegs));\n', ""),
            ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));\n', "")],
    },
    "k1f64": {
        "intact": [],
        # shapes: the products of one m16n8k4 as two m8n8k4 (rows g, g + 8)
        "mma_m8n8k4": [(
            '    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "\n'
            '        "{%4, %5}, {%6}, {%0, %1, %2, %3};"\n'
            '        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])\n'
            '        : "d"(a[0]), "d"(a[1]), "d"(b[0]));',
            '    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "\n'
            '        "{%0, %1};" : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));\n'
            '    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "\n'
            '        "{%0, %1};" : "+d"(d[2]), "+d"(d[3]) : "d"(a[1]), "d"(b[0]));')],
        "mma_m16n8k8": [("constexpr int kMmaK = 4;", "constexpr int kMmaK = 8;")],
        "mma_m16n8k16": [("constexpr int kMmaK = 4;", "constexpr int kMmaK = 16;")],
        # settings: the products' k loop unrolled 1 or 4 times instead of 2
        "unroll_1": [("#pragma unroll 2\n  for (int k = 0;", "#pragma unroll 1\n  for (int k = 0;")],
        "unroll_4": [("#pragma unroll 2\n  for (int k = 0;", "#pragma unroll 4\n  for (int k = 0;")],
        # knock-outs: one FMA per fragment instead of an mma (loads kept)
        "products_as_one_fma": [("      for (int m = 0; m < M16; ++m) Mma<kMmaK>::run(acc[n][m], a[m], b[n]);",
                                 "      for (int m = 0; m < M16; ++m) acc[n][m][0] = fma(a[m][0], b[n][0], acc[n][m][0]);")],
        "no_weight_loads": [("        b[n][j] = __ldg(b_ptr + static_cast<size_t>(k + 4 * j) * ldw + 8 * n);",
                             "        b[n][j] = 1e-3 * (k + 4 * j + 8 * n);")],
        "no_sines": [("? u : sinf(u + __ldg(w.f(kEmbPhase) + l));",
                      "? u : u + __ldg(w.f(kEmbPhase) + l);")],
        # the full variant's epilogue projections run twice, each time
        # writing the same values: the partials (the f64 dot products and
        # the butterflies), or the sums over warps and the output stores.
        # (Removing them instead lets the compiler drop pos_feat's and
        # view_feat's products too, whose values nothing else reads.)
        "head_partials_twice": [
            ("  for (int ci = 0; ci < nc; ++ci) {\n    const int c = column(pr, ci);",
             "  for (int cj = 0; cj < 2 * nc; ++cj) {\n    const int ci = cj % nc;\n"
             "    const int c = column(pr, ci);")],
        "head_sums_twice": [
            ("  for (int i = i0; i < items; i += step) {\n    const int ci = i / kTile",
             "  for (int j = i0; j < 2 * items; j += step) {\n    const int i = j % items;\n"
             "    const int ci = i / kTile")],
    },
}
# the k1f64 variants that compute what the intact kernel does, held to the
# plain version
K1F64_CHECKED = ("intact", "mma_m8n8k4", "mma_m16n8k8", "mma_m16n8k16", "unroll_1",
                 "unroll_4", "head_partials_twice", "head_sums_twice")
SOURCES = {"k3": "fused_field_train", "k2": "fused_field_train", "k1": "fused_field",
           "k1bf16": "fused_field_bf16", "k1f64": "fused_field_f64"}
OUT = kb.BUILD_DIR / "knockout"
# the entry point of K2 before its weights became a slab stream
_PARENT_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_BIASES = ("tb", "bpf", "bfeat", "bv", "bcf", "bias")


def build_variants(source: str, variants: dict, extra: dict[str, str],
                   logs: dict | None = None) -> dict[str, Path]:
    """One library per variant of csrc/<source>.cu (with the field chain's
    header written out in place of its include, so that substitutions
    reach it), and one per `extra` source text (name -> text), nvcc all at
    once; the compiler's output of each goes into `logs`."""
    src = (kb.CSRC / f"{source}.cu").read_text()
    include = f'#include "{CHAIN_HEADER}"'
    src = src.replace(include, (kb.CSRC / CHAIN_HEADER).read_text())
    OUT.mkdir(parents=True, exist_ok=True)
    texts = dict(extra)
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        (OUT / f"{name}.cu").write_text(text)
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC), "-o", str(OUT / f"lib{name}.so"),
               str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        if logs is not None:
            logs[name] = out
    return {name: OUT / f"lib{name}.so" for name in texts}


def inputs(n: int, gen, n_out: int):
    pts = torch.rand((n, 1, 3), device="cuda", generator=gen) * 4 - 2
    dirs = torch.nn.functional.normalize(torch.randn((n, 3), device="cuda", generator=gen),
                                         dim=-1)
    return ff._pack_inputs(pts, dirs), torch.randn((n, n_out), device="cuda", generator=gen) * 1e-3


def parent_forward(fn, x, w16, emb):
    """The earlier K2: raw and residuals, its matrices transposed per call."""
    n, n_out, width = x.shape[0], w16["bias"].shape[0], w16["w1"].shape[0]
    wt = [w16[k] if k in _BIASES else w16[k].t().contiguous() for k in fft._DW_ORDER]
    raw = torch.empty((n, n_out), dtype=torch.float32, device=x.device)
    res = torch.empty((len(fft._RES_ORDER), n, width), dtype=torch.bfloat16, device=x.device)
    err = fn(x.data_ptr(), n, emb["E"].data_ptr(), emb["phase"].data_ptr(), emb["id"].data_ptr(),
             fft._ptrs([t.data_ptr() for t in wt]), len(wt), width, n_out, w16["wcf"].shape[1],
             raw.data_ptr(), res.data_ptr(), fft._stream(x.device))
    if err != 0:
        raise RuntimeError(f"the earlier K2 failed to launch: error {err}")
    return raw, res


def slab_parent_forward(fn, x, w16, emb):
    """An earlier K2 whose entry point takes the slab stream, as today's."""
    entry = fft._entries
    fft._entries = lambda: (fn, entry()[1])
    try:
        return fft._launch_fwd(x, w16, emb)
    finally:
        fft._entries = entry


def parent_check(fn, w16, emb, gen, n_out, forward) -> bool:
    """The intact K2 and an earlier one (`forward(fn, x, w16, emb)`)
    against the plain version, raw and every residual plane within
    chip_smoke's TRAIN_KERNEL_REL, at the smoke's six point counts (per
    block: both errors, and whether the two kernels agree bit for bit);
    then both timed in turns (parent, new, new, parent) at the fine pass
    and at the cells' K2 shapes, the new one also without residual
    stores. Returns whether both held the gate."""
    fine = 512 * (64 + 128)
    ok, checks = True, {}
    for n in (1, 63, 4097, fine + 37, 512 * 64, fine):
        x, _ = inputs(n, gen, n_out)
        raw_p, res_p = fft.train_forward_plain(x, w16, emb)
        raw, res = fft._launch_fwd(x, w16, emb)
        raw_o, res_o = forward(fn, x, w16, emb)
        torch.cuda.synchronize()
        blocks = {"raw": (raw, raw_o, raw_p), **{k: (res[i], res_o[i], res_p[i])
                                                 for i, k in enumerate(fft._RES_ORDER)}}
        errs = {k: (cs.rel_err(a, p), cs.rel_err(b, p)) for k, (a, b, p) in blocks.items()}
        ok &= all(max(e) <= cs.TRAIN_KERNEL_REL for e in errs.values())
        checks[n] = {"worst_rel_err": [max(e[0] for e in errs.values()),
                                       max(e[1] for e in errs.values())],
                     "blocks_not_bit_equal": sum(not torch.equal(a, b)
                                                 for a, b, _ in blocks.values())}
    print(json.dumps({"parent_check": {"held": ok, "rel_bound": cs.TRAIN_KERNEL_REL,
                                       "per_points": checks}}), flush=True)
    for n in (fine, *cs.K2_CELL_SHAPES):
        x, _ = inputs(n, gen, n_out)
        new = lambda: fft._launch_fwd(x, w16, emb)                     # noqa: E731
        nores = lambda: fft._launch_fwd(x, w16, emb, residuals=False)  # noqa: E731
        old = lambda: forward(fn, x, w16, emb)                         # noqa: E731
        new(), nores(), old()
        o1, n1, r1, r2, n2, o2 = (cs.time_ms(old, 10), cs.time_ms(new, 10),
                                  cs.time_ms(nores, 10), cs.time_ms(nores, 10),
                                  cs.time_ms(new, 10), cs.time_ms(old, 10))
        print(json.dumps({"parent_turns": n, "ms": [n1, n2], "nores_ms": [r1, r2],
                          "parent_ms": [o1, o2]}), flush=True)
        del x
        torch.cuda.empty_cache()
    return ok


# the entry point of K1 before it took a projection table
_K1_PARENT_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]


def k1_runner(fn, old_abi: bool, packed, cfg, pts, dirs):
    """A call of one K1 build (its own `fused_field_launch`, with no
    projection table if `old_abi`) on these inputs, through the
    wrapper's checks; dirs None for density."""
    x = ff._pack_inputs(pts, dirs)
    density = dirs is None
    n_cols = 1 if density else 9 + 3 * cfg.coarse_radiance_number
    ptrs = (ctypes.c_void_p * len(ff._WEIGHT_ORDER))(
        *[packed[k].data_ptr() for k in ff._WEIGHT_ORDER])
    table = ff._proj_table(cfg.coarse_radiance_number)
    dims = (len(ff._WEIGHT_ORDER), cfg.width, cfg.input_ch, cfg.input_ch_views,
            cfg.coarse_radiance_number, int(density))
    extra = () if old_abi else (ctypes.cast(table, ctypes.c_void_p), len(table) // 4)
    ff._check(packed, x, cfg)

    def run():
        out = torch.empty((x.shape[0], n_cols), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), x.shape[0], ctypes.cast(ptrs, ctypes.c_void_p), *dims, *extra,
                 out.data_ptr(), fft._stream(x.device))
        if err != 0:
            raise RuntimeError(f"K1 launch failed: error {err}")
        return out
    return run


def k1_main(args, card: str, extra: dict) -> int:
    logs: dict = {}
    libs = build_variants(SOURCES["k1"], VARIANTS["k1"], extra, logs)
    old_abi = "parent" in extra and "const int* proj" not in extra["parent"]
    fns = {}
    for name in libs:
        fn = ctypes.CDLL(str(libs[name])).fused_field_launch
        fn.restype = ctypes.c_int
        fn.argtypes = _K1_PARENT_ARGS if name == "parent" and old_abi else ff.ENTRY_ARGS
        fns[name] = fn
    cfg = FieldConfig(depth=8, width=256, coarse_radiance_number=3)
    params = init_field_params(np.random.default_rng(cs.SEED), cfg, "cuda")
    params["sigma"]["b"] += 0.5
    packed = ff.pack_field_weights(params, cfg)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    occ = ctypes.CDLL(str(libs["intact"])).fused_field_occupancy
    occupancy = {}
    for density in (False, True):
        blocks, smem = ctypes.c_int(), ctypes.c_longlong()
        if occ(cfg.input_ch, cfg.input_ch_views, cfg.coarse_radiance_number, int(density),
               ctypes.byref(blocks), ctypes.byref(smem)) != 0:
            raise RuntimeError("occupancy query failed")
        occupancy["density" if density else "full"] = {
            "smem_bytes_per_block": smem.value, "blocks_per_sm": blocks.value}
    print(json.dumps({"ptxas": {k: cs.k1_ptxas(v) for k, v in logs.items()},
                      "occupancy": occupancy}), flush=True)

    def inputs(lead, with_dirs):
        pts, dirs = cs.k1_inputs(lead, gen)
        return pts, dirs if with_dirs else None

    def plain(pts, dirs):
        return (ff.fused_field_density_plain(packed, pts, cfg) if dirs is None
                else ff.fused_field_apply_plain(packed, pts, dirs, cfg))

    full, train = 2048 * 64, 512 * 64
    density = 4 * 2048 * 192
    density_more = [a * b for a, b in cs.K1_DENSITY_SHAPES]
    ok = True
    checked = ["intact"] + (["parent"] if "parent" in fns else [])
    for n, with_dirs in ((full + 37, True), (full, True), (train, True),
                         (density + 37, False), (density, False),
                         *((m, False) for m in density_more)):
        pts, dirs = inputs((n, 1), with_dirs)
        ref = plain(pts, dirs).reshape(n, -1)
        for name in checked:
            out = k1_runner(fns[name], name == "parent" and old_abi, packed, cfg, pts, dirs)()
            torch.cuda.synchronize()
            err = (out - ref).abs()
            bad = int((err > cs.KERNEL_ATOL + cs.KERNEL_RTOL * ref.abs()).sum())
            bad += int((~torch.isfinite(out)).sum())
            rel = cs.rel_err(out, ref)
            ok &= bad == 0 and (with_dirs or rel <= cs.K1_DENSITY_REL)
            print(json.dumps({"check": name, "points": n, "full": with_dirs,
                              "max_abs_err": err.max().item(), "values_off": bad,
                              "rel_err_vs_plain": rel}), flush=True)
        del ref
    torch.cuda.empty_cache()

    cases = {"full": (full, True), "full_train": (train, True), "density": (density, False),
             **{f"density_{m}": (m, False) for m in density_more}}
    runs = {}
    for case, (n, with_dirs) in cases.items():
        pts, dirs = inputs((n, 1), with_dirs)
        runs[case] = {name: k1_runner(fn, name == "parent" and old_abi, packed, cfg, pts, dirs)
                      for name, fn in fns.items()}
    if "parent" in fns:
        for case, r in runs.items():
            new, old = r["intact"], r["parent"]
            new(), old()
            o1, n1, n2, o2 = (cs.time_ms(old, 10), cs.time_ms(new, 10), cs.time_ms(new, 10),
                              cs.time_ms(old, 10))
            print(json.dumps({"parent_turns": case, "points": cases[case][0],
                              "ms": [n1, n2], "parent_ms": [o1, o2]}), flush=True)
    intact = {case: runs[case]["intact"]() for case in ("full", "density")}
    for name in ("intact", *(["parent"] if "parent" in fns else []), "no_weight_loads",
                 "no_act_loads"):
        print(json.dumps({"clocks_under_density": name,
                          **clocks_under(runs["density"][name])}), flush=True)
    for rnd in range(2):
        for name in VARIANTS["k1"]:
            ms, diff = {}, {}
            for case in ("full", "density"):
                run = runs[case][name]
                # a knock-out is wrong by design; a setting must agree
                diff[case] = (run() - intact[case]).abs().max().item()
                ms[case] = cs.time_ms(run, 10)
            print(json.dumps({"variant": name, "round": rnd, "ms": ms,
                              "max_abs_diff_vs_intact": diff}), flush=True)
    print(card)
    return 0 if ok else 1


# the entry point of K1 at bf16 weights when csrc/fused_field_train.cu held it
_K1BF16_PARENT_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def k1bf16_runner(fn, occ, parent: bool, w16, emb, x, density: bool):
    """A call of one build of K1 at bf16 weights on this input: today's
    entry point through `fused_field_bf16.launch`, or the parent's with
    the same slab stream."""
    if not parent:
        def run():
            entry = k1b._entries
            k1b._entries = lambda: (fn, occ)
            try:
                return k1b.launch(x, w16, emb, density)
            finally:
                k1b._entries = entry
        return run
    n_out = w16["bias"].shape[0]
    sched, n_slabs = (fft.density_schedule if density else fft.forward_schedule)(fft._shapes(w16))

    def run():
        out = torch.empty((x.shape[0], 1 if density else n_out), dtype=torch.float32,
                          device=x.device)
        slabs = torch.empty(n_slabs * fft.SLAB_N * fft.SLAB_K, dtype=torch.bfloat16,
                            device=x.device)
        err = fn(x.data_ptr(), x.shape[0], emb["E"].data_ptr(), emb["phase"].data_ptr(),
                 emb["id"].data_ptr(), fft._ptrs([w16[k].data_ptr() for k in fft._DW_ORDER]),
                 len(fft._DW_ORDER), 256, n_out, w16["wcf"].shape[1], int(density),
                 ctypes.cast(fft._slab_table(sched), ctypes.c_void_p), len(sched),
                 slabs.data_ptr(), n_slabs, out.data_ptr(), fft._stream(x.device))
        if err != 0:
            raise RuntimeError(f"the parent's K1-bf16 failed to launch: error {err}")
        return out
    return run


def clocks_under(run, seconds: float = 2.0) -> dict:
    """The SM clock (MHz) and the power draw (W) that nvidia-smi samples
    every 100 ms while `run` repeats for about `seconds`: min, median and
    max of each."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = [[float(v) for v in ln.split(",")] for ln in out.splitlines() if ln.strip()][2:]
    return {k: [min(c), statistics.median(c), max(c)]
            for k, c in zip(("sm_mhz", "power_w"), zip(*rows))} if rows else {}


def k1bf16_main(card: str, extra: dict) -> int:
    logs: dict = {}
    libs = build_variants(SOURCES["k1bf16"], VARIANTS["k1bf16"], extra, logs)
    fns = {}
    for name, lib in libs.items():
        dll = ctypes.CDLL(str(lib))
        if name == "parent":
            fn = dll.fused_field_bf16_launch
            fn.restype, fn.argtypes = ctypes.c_int, _K1BF16_PARENT_ARGS
            fns[name] = (fn, None)
            continue
        fn, occ = dll.fused_field_bf16_launch, dll.fused_field_bf16_occupancy
        fn.restype, fn.argtypes = ctypes.c_int, k1b.LAUNCH_ARGS
        occ.restype, occ.argtypes = ctypes.c_int, k1b.OCCUPANCY_ARGS
        fns[name] = (fn, occ)
    entry = k1b._entries
    k1b._entries = lambda: fns["intact"]
    try:
        occupancy = {m: k1b.occupancy(m == "density") for m in ("density", "full")}
    finally:
        k1b._entries = entry
    print(json.dumps({"ptxas": {k: cs.k1_ptxas(v, "k1_bf16_field") for k, v in logs.items()},
                      "ptxas_warnings": [ln for ln in logs["intact"].splitlines()
                                         if "arning" in ln],
                      "occupancy": occupancy}), flush=True)

    cfg = FieldConfig(depth=8, width=256, coarse_radiance_number=3)
    params = init_field_params(np.random.default_rng(cs.SEED), cfg, "cuda")
    params["sigma"]["b"] += 0.5
    w16 = ff.pack_field_weights(params, cfg, dtype=torch.bfloat16)
    emb = fft.emb_constants(cfg, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def inputs(n, density):
        pts, dirs = cs.k1_inputs((n, 1), gen)
        return ff._pack_inputs(pts, None if density else dirs)

    def runner(name, x, density):
        fn, occ = fns[name]
        return k1bf16_runner(fn, occ, name == "parent", w16, emb, x, density)

    full, train, density = 2048 * 64, 512 * 64, 4 * 2048 * 192
    ok = True
    checked = ["intact"] + (["parent"] if "parent" in fns else [])
    for n, dens in ((full + 37, False), (full, False), (train, False), (density + 37, True),
                    (density, True)):
        x = inputs(n, dens)
        ref = fft.field_bf16_plain(x, w16, emb, dens)
        for name in checked:
            run = runner(name, x, dens)
            out, again = run(), run()
            torch.cuda.synchronize()
            err = cs.rel_err(out, ref)
            finite = bool(torch.isfinite(out).all())
            same = torch.equal(out, again)
            ok &= finite and err <= cs.TRAIN_KERNEL_REL and (same or name == "parent")
            print(json.dumps({"check": name, "points": n, "density": dens, "rel_err": err,
                              "finite": finite, "rerun_identical": same}), flush=True)
        del ref
    torch.cuda.empty_cache()

    cases = {"full": (full, False), "full_train": (train, False), "density": (density, True)}
    xs = {case: inputs(n, dens) for case, (n, dens) in cases.items()}
    if "parent" in fns:
        for case, (n, dens) in cases.items():
            new, old = runner("intact", xs[case], dens), runner("parent", xs[case], dens)
            new(), old()
            o1, n1, n2, o2 = (cs.time_ms(old, 10), cs.time_ms(new, 10), cs.time_ms(new, 10),
                              cs.time_ms(old, 10))
            print(json.dumps({"parent_turns": case, "points": n, "ms": [n1, n2],
                              "parent_ms": [o1, o2]}), flush=True)
    for name in checked:   # the card's clock and power under each density kernel
        print(json.dumps({"clocks_under": name, "case": "density",
                          **clocks_under(runner(name, xs["density"], True))}), flush=True)
    intact = {case: runner("intact", xs[case], cases[case][1])() for case in ("full", "density")}
    for rnd in range(2):
        for name in VARIANTS["k1bf16"]:
            ms, diff = {}, {}
            for case in ("full", "density"):
                run = runner(name, xs[case], cases[case][1])
                # a knock-out is wrong by design; a setting must agree
                diff[case] = (run() - intact[case]).abs().max().item()
                ms[case] = cs.time_ms(run, 10)
            print(json.dumps({"variant": name, "round": rnd, "ms": ms,
                              "max_abs_diff_vs_intact": diff}), flush=True)
    print(card)
    return 0 if ok else 1


def k1f64_main(card: str, extra: dict) -> int:
    logs: dict = {}
    libs = build_variants(SOURCES["k1f64"], VARIANTS["k1f64"], extra, logs)
    entries = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        launch, occ = lib.fused_field_f64_launch, lib.fused_field_f64_occupancy
        launch.restype, launch.argtypes = ctypes.c_int, ff.ENTRY_ARGS
        occ.restype, occ.argtypes = ctypes.c_int, k1d.OCCUPANCY_ARGS
        entries[name] = (launch, occ)
    cfg = FieldConfig(depth=8, width=256, coarse_radiance_number=3)
    params = init_field_params(np.random.default_rng(cs.SEED), cfg, "cuda")
    params["sigma"]["b"] += 0.5
    packed = ff.pack_field_weights(params, cfg, dtype=torch.float64)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    parent = "parent" in entries
    original = k1d._entries

    def use(name):
        k1d._entries = lambda: entries[name]

    try:
        occupancy = {}
        for name in ("intact", "parent") if parent else ("intact",):
            use(name)
            occupancy[name] = {"density": k1d.occupancy(cfg, True),
                               "full": k1d.occupancy(cfg, False)}
        print(json.dumps({
            "ptxas": {k: cs.k1_ptxas(v, "fused_field_f64_kernel") for k, v in logs.items()},
            "occupancy": occupancy}), flush=True)
        ok, calls = True, {}
        mc = cs.K1_MC_SHAPE
        cases = (("full", (131072, 1), True), ("full_mc_march", mc, True),
                 ("density", (1572864, 1), False))
        for case, lead, with_dirs in cases:
            kern, plain = cs.k1_calls(packed, cfg, *cs.k1_inputs(lead, gen), with_dirs)
            ref, outs = plain(), {}
            names = (K1F64_CHECKED if case != "full_mc_march" else ("intact",)) + (
                ("parent",) if parent else ())
            for name in names:
                use(name)
                out, again = kern(), kern()
                err = cs.rel_err(out, ref)
                same = torch.equal(out, again)
                ok &= err <= cs.K1_F64_REL[with_dirs] and same
                outs[name] = out
                print(json.dumps({"check": name, "case": case, "points": lead[0] * lead[1],
                                  "rel_err_vs_plain": err, "bound": cs.K1_F64_REL[with_dirs],
                                  "not_bit_equal_to_plain": int((out != ref).sum()),
                                  "rerun_identical": same}), flush=True)
            if parent:
                # the density variant's output must not move; the full one's is reported
                same = torch.equal(outs["intact"], outs["parent"])
                ok &= same or with_dirs
                print(json.dumps({"parent_identical": same, "case": case}), flush=True)
            del ref, outs
            calls[case] = (lead[0] * lead[1], kern)
        torch.cuda.empty_cache()
        if parent:
            for case, (n, kern) in calls.items():
                runs = {}
                for name in ("parent", "intact", "intact", "parent"):
                    use(name)
                    kern()
                    runs.setdefault(name, []).append(cs.time_ms(kern, 3))
                print(json.dumps({"parent_turns": case, "points": n, "ms": runs["intact"],
                                  "parent_ms": runs["parent"]}), flush=True)
        for rnd in range(2):
            for name in VARIANTS["k1f64"]:
                use(name)
                ms = {}
                for case, (_, kern) in calls.items():
                    if case != "full_mc_march":
                        kern()  # a build's first launch loads its module
                        ms[case] = cs.time_ms(kern, 3)
                print(json.dumps({"variant": name, "round": rnd, "ms": ms}), flush=True)
    finally:
        k1d._entries = original
    print(card)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", nargs="?", choices=sorted(VARIANTS), default="k3")
    ap.add_argument("--parent", type=Path,
                    help="source of an earlier K2, K1 or K1 at bf16 or f64 weights "
                         "(k2, k1, k1bf16, k1f64)")
    args = ap.parse_args()
    if args.parent and args.kernel == "k3":
        ap.error("--parent applies to k2, k1, k1bf16 and k1f64")
    if not torch.cuda.is_available():
        print("k3_knockout: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    extra = {"parent": args.parent.read_text()} if args.parent else {}
    if args.kernel == "k1":
        return k1_main(args, card, extra)
    if args.kernel == "k1bf16":
        return k1bf16_main(card, extra)
    if args.kernel == "k1f64":
        return k1f64_main(card, extra)
    libs = build_variants(SOURCES[args.kernel], VARIANTS[args.kernel], extra)
    entry = fft._entries
    fwd0, bwd0 = entry()
    stage = {"k3": 1, "k2": 0}[args.kernel]
    entries = {}
    for name in VARIANTS[args.kernel]:
        lib = ctypes.CDLL(str(libs[name]))
        fn = lib.fused_field_train_bwd_launch if stage else lib.fused_field_train_fwd_launch
        base = bwd0 if stage else fwd0
        fn.restype, fn.argtypes = base.restype, base.argtypes
        entries[name] = fn

    cfg = FieldConfig(depth=8, width=256, coarse_radiance_number=3)
    w16 = fft.to_bf16(ff.pack_field_weights(
        init_field_params(np.random.default_rng(cs.SEED), cfg, "cuda"), cfg))
    emb = fft.emb_constants(cfg, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    n, n_out = 512 * (64 + 128), 9 + 3 * cfg.coarse_radiance_number
    ok = True
    if args.parent:
        fn = ctypes.CDLL(str(libs["parent"])).fused_field_train_fwd_launch
        slab_abi = "int n_slab_ops" in extra["parent"]
        fn.restype, fn.argtypes = ctypes.c_int, (fwd0.argtypes if slab_abi else _PARENT_ARGS)
        ok = parent_check(fn, w16, emb, gen, n_out,
                          slab_parent_forward if slab_abi else parent_forward)
    x, g = inputs(n, gen, n_out)
    _, res = fft._launch_fwd(x, w16, emb)
    update_fine = cs.K2_CELL_SHAPES[1]
    x_cell = inputs(update_fine, gen, n_out)[0] if stage == 0 else None
    intact = None
    try:
        for rnd in range(2):
            for name, fn in entries.items():
                line = {}
                if stage:
                    fft._entries = lambda fn=fn: (fwd0, fn)
                    run = lambda: fft._launch_bwd(x, g, res, w16, emb)   # noqa: E731
                else:
                    fft._entries = lambda fn=fn: (fn, bwd0)
                    run = lambda: fft._launch_fwd(x, w16, emb)           # noqa: E731
                    nores = lambda: fft._launch_fwd(x, w16, emb, residuals=False)  # noqa: E731
                    line["ms_nores"] = cs.time_ms(nores, 10)
                    line[f"ms_at_{update_fine}"] = cs.time_ms(
                        lambda: fft._launch_fwd(x_cell, w16, emb), 5)
                    line[f"ms_nores_at_{update_fine}"] = cs.time_ms(
                        lambda: fft._launch_fwd(x_cell, w16, emb, residuals=False), 5)
                out = run()
                torch.cuda.synchronize()
                blocks = (list(out.values()) if stage else [out[0], *out[1]])
                if intact is None:
                    intact = blocks
                err = max(cs.rel_err(a, b) for a, b in zip(blocks, intact))
                print(json.dumps({"variant": name, "round": rnd, "points": n,
                                  "stage_ms": cs.stage_ms(run, args.kernel + "_", iters=10),
                                  "ms": cs.time_ms(run, 10), **line,
                                  "rel_err_vs_intact": err}),
                      flush=True)
    finally:
        fft._entries = entry
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
