#!/usr/bin/env python3
"""K3, K2, K1 (f32 weights) or K1 at bf16 weights with one part knocked out
at a time.

    python3 k3_knockout.py                # K3, from the root of a checkout, one card
    python3 k3_knockout.py k2             # K2
    python3 k3_knockout.py k2 --parent OLD.cu
    python3 k3_knockout.py k1 --parent OLD.cu
    python3 k3_knockout.py k1bf16 --parent OLD.cu

Builds `ibl_nerf_tpu_torch/csrc/fused_field_train.cu` as it is and once
per variant -- a text substitution that removes one part of the kernel
(K3: of `k3_delta_chain`; K2: of `k2_forward`, with the chain code it
shares with K3) or changes one setting -- all nvcc processes at once,
then times the kernel at the fine pass's point count (512 x 192) by
stage (torch.profiler, as chip_smoke.stage_ms), every variant in turn,
twice. A variant's outputs are wrong by design (its relative error to
the intact kernel is printed to show it ran); only its time means
something: what a part costs is at most the intact kernel's time minus
the variant's. One JSON line per variant and round, then the card line.

With `--parent`, the source of an earlier K2 is built too -- its entry
point either takes the slab stream as today's does, or every weight
matrix transposed to [out][in] -- and its raw output and residuals are
held against the intact K2's bit for bit at chip_smoke's six point
counts (the run exits 1 if any differ), and the two are timed in turns
at the fine pass. Fails without CUDA, and when a substitution's text is
gone from the source.

K1 (`k1`) knocks parts out of `csrc/fused_field.cu` and times both
variants at the serving shapes (full at 2048 x 64 points, density at
4 x 2048 x 192), by CUDA events, every variant in turn, twice, with
each variant's registers and spills and the blocks an SM holds.
`k1 --parent OLD.cu` takes an earlier K1 source, its entry point with
or without the projection table (e.g. `git show
<commit>:ibl_nerf_tpu_torch/csrc/fused_field.cu` into the git-ignored
`build/`): both are held against the plain version under
chip_smoke's K1 gate at ragged and main-path counts (the run exits 1 if
either fails), then timed in turns (parent, new, new, parent) with full
at 131,072 and at the train step's 32,768 points and density at
1,572,864.

K1 at bf16 weights (`k1bf16`) knocks parts out of
`csrc/fused_field_bf16.cu` (the wgmma products, the TMA weight copies,
the epilogues' stores to shared memory, their bf16 conversions, their
proxy fence, the sines; settings: a density
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
# every epilogue projection run twice (on column c ^ 1 the second time)
K1_PROJ = ("      o[c * kStride] += s;",
           "      o[c * kStride] += s + project_col<NCOL>(v, P, n_out, c ^ 1, t);")
HEAD_MMA = ("      mma16816(acc[0], a[0], a[1], a[2], a[3], b[0], b[1]);\n"
            "      mma16816(acc[1], a[0], a[1], a[2], a[3], b[2], b[3]);\n",
            "")
SLABS = ("    if (issued < total) {\n      const bf16_t* s = src",
         "    if (issued < 0) {\n      const bf16_t* s = src")
BARRIERS = ("    cp_async_wait<kRing - 2>();\n    __syncthreads();\n    issue();",
            "    issue();")
SINES = ("return __ldg(emb.id + l) > 0.f ? t : sinf(t + __ldg(emb.phase + l));",
         "return __ldg(emb.id + l) > 0.f ? t : t + __ldg(emb.phase + l);")
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
        "no_products": [MMA, HEAD_MMA],            # the mma.sync of the layers and heads
        "no_slab_loads": [SLABS],
        "no_products_no_slab_loads": [MMA, HEAD_MMA, SLABS],
        "no_slab_barriers": [BARRIERS],
        "no_residual_stores": [("    store_tile(res", "    if (n < 0) store_tile(res")],
        "no_sines": [SINES],
    },
    "k1": {
        "intact": [],
        "eighth_products": [K1_FMA],               # 1 FMA of 8 in every layer; loads kept
        "no_weight_loads": [K1_LOADS],
        "eighth_products_no_weight_loads": [K1_FMA, K1_LOADS],
        "projections_twice": [K1_PROJ],            # the full variant's epilogue projections
        "no_barriers": [('  asm volatile("bar.sync %0, 128;" ::"r"(quad + 1) : "memory");', "")],
        "no_sines": [("? u : sinf(u + __ldg(w.p[kEmbPhase] + l));",
                      "? u : u + __ldg(w.p[kEmbPhase] + l);")],
        "no_act_loads": [
            ("    const float4 a0 = *reinterpret_cast<const float4*>(in + k * kStride + t.prow);",
             "    const float4 a0 = make_float4(k, 1.f, 2.f, 3.f);"),
            ("        *reinterpret_cast<const float4*>(in + k * kStride + t.prow + 4);",
             "        make_float4(k, 5.f, 6.f, 7.f);")],
        # settings: the k loop unrolled 2 or 8 times instead of 4
        "unroll_2": [("#pragma unroll 4\n  for (int k = 0;", "#pragma unroll 2\n  for (int k = 0;")],
        "unroll_8": [("#pragma unroll 4\n  for (int k = 0;", "#pragma unroll 8\n  for (int k = 0;")],
    },
    "k1bf16": {
        "intact": [],
        "no_products": [("        Wgmma<N>::mma(acc, sw64_desc(a), sw64_desc(bb), scale);\n"
                         "        Wgmma<N>::mma(acc, sw64_desc(a + 32), sw64_desc(bb + 32), 1);\n",
                         "")],
        "no_weight_copies": [
            ("          mbar_expect_tx(full + 8 * stage, kSlabBytes);\n"
             "          tma_load_slab(base + stage * kSlabBytes, &slab_map, s * kSlabN, full + 8 * stage);\n",
             "          mbar_arrive(full + 8 * stage);\n")],
        "no_epilogue_stores": [('    asm volatile("stmatrix.sync.aligned',
                                '    if (wg < 0) asm volatile("stmatrix.sync.aligned')],
        "no_epilogue_cvt": [
            ('        asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\\n" : "=r"(pk[q]) : "f"(v1), "f"(v0));\n'
             '      else\n'
             '        asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n" : "=r"(pk[q]) : "f"(v1), "f"(v0));',
             '        pk[q] = __float_as_uint(v0) ^ __float_as_uint(v1);\n'
             '      else\n'
             '        pk[q] = __float_as_uint(v1);')],
        "no_epilogue_fence": [("  fence_async_smem();\n  wg_sync(wg);\n}\n\n// One pass of a layer",
                               "  wg_sync(wg);\n}\n\n// One pass of a layer")],
        "no_sines": [("(arg == 0.f ? arg : sinf(arg))", "arg")],
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
}
SOURCES = {"k3": "fused_field_train", "k2": "fused_field_train", "k1": "fused_field",
           "k1bf16": "fused_field_bf16"}
OUT = kb.BUILD_DIR / "knockout"
# the entry point of K2 before its weights became a slab stream
_PARENT_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_BIASES = ("tb", "bpf", "bfeat", "bv", "bcf", "bias")


def build_variants(source: str, variants: dict, extra: dict[str, str],
                   logs: dict | None = None) -> dict[str, Path]:
    """One library per variant of csrc/<source>.cu, and one per `extra`
    source text (name -> text), nvcc all at once; the compiler's output
    of each goes into `logs`."""
    src = (kb.CSRC / f"{source}.cu").read_text()
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
    """The intact K2 against the earlier one (`forward(fn, x, w16, emb)`),
    bit for bit, at the smoke's six point counts (per block: true, or the
    max abs difference); then both timed in turns at the fine pass.
    Returns whether all were equal."""
    fine = 512 * (64 + 128)
    equal = {}
    for n in (1, 63, 4097, fine + 37, 512 * 64, fine):
        x, _ = inputs(n, gen, n_out)
        raw, res = fft._launch_fwd(x, w16, emb)
        raw_o, res_o = forward(fn, x, w16, emb)
        torch.cuda.synchronize()
        blocks = {"raw": (raw, raw_o), **{k: (res[i], res_o[i])
                                          for i, k in enumerate(fft._RES_ORDER)}}
        equal[n] = {k: torch.equal(a, b) or (a.float() - b.float()).abs().max().item()
                    for k, (a, b) in blocks.items()}
    new = lambda: fft._launch_fwd(x, w16, emb)             # noqa: E731
    old = lambda: forward(fn, x, w16, emb)                 # noqa: E731
    new(), old()
    o1, n1, n2, o2 = (cs.time_ms(old, 10), cs.time_ms(new, 10), cs.time_ms(new, 10),
                      cs.time_ms(old, 10))
    identical = all(v is True for e in equal.values() for v in e.values())
    print(json.dumps({"parent_check": {"identical": identical, "per_points": equal},
                      "points": fine, "ms": [n1, n2], "parent_ms": [o1, o2]}), flush=True)
    return identical


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

    full, train, density = 2048 * 64, 512 * 64, 4 * 2048 * 192
    ok = True
    checked = ["intact"] + (["parent"] if "parent" in fns else [])
    for n, with_dirs in ((full + 37, True), (full, True), (train, True),
                         (density + 37, False), (density, False)):
        pts, dirs = inputs((n, 1), with_dirs)
        ref = plain(pts, dirs).reshape(n, -1)
        for name in checked:
            out = k1_runner(fns[name], name == "parent" and old_abi, packed, cfg, pts, dirs)()
            torch.cuda.synchronize()
            err = (out - ref).abs()
            bad = int((err > cs.KERNEL_ATOL + cs.KERNEL_RTOL * ref.abs()).sum())
            bad += int((~torch.isfinite(out)).sum())
            ok &= bad == 0
            print(json.dumps({"check": name, "points": n, "full": with_dirs,
                              "max_abs_err": err.max().item(), "values_off": bad}), flush=True)
        del ref
    torch.cuda.empty_cache()

    cases = {"full": (full, True), "full_train": (train, True), "density": (density, False)}
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", nargs="?", choices=sorted(VARIANTS), default="k3")
    ap.add_argument("--parent", type=Path,
                    help="source of an earlier K2, K1 or K1 at bf16 weights (k2, k1, k1bf16)")
    args = ap.parse_args()
    if args.parent and args.kernel == "k3":
        ap.error("--parent applies to k2, k1 and k1bf16")
    if not torch.cuda.is_available():
        print("k3_knockout: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    extra = {"parent": args.parent.read_text()} if args.parent else {}
    if args.kernel == "k1":
        return k1_main(args, card, extra)
    if args.kernel == "k1bf16":
        return k1bf16_main(card, extra)
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
    identical = True
    if args.parent:
        fn = ctypes.CDLL(str(libs["parent"])).fused_field_train_fwd_launch
        slab_abi = "int n_slab_ops" in extra["parent"]
        fn.restype, fn.argtypes = ctypes.c_int, (fwd0.argtypes if slab_abi else _PARENT_ARGS)
        identical = parent_check(fn, w16, emb, gen, n_out,
                                 slab_parent_forward if slab_abi else parent_forward)
    x, g = inputs(n, gen, n_out)
    _, res = fft._launch_fwd(x, w16, emb)
    intact = None
    try:
        for rnd in range(2):
            for name, fn in entries.items():
                if stage:
                    fft._entries = lambda fn=fn: (fwd0, fn)
                    run = lambda: fft._launch_bwd(x, g, res, w16, emb)   # noqa: E731
                else:
                    fft._entries = lambda fn=fn: (fn, bwd0)
                    run = lambda: fft._launch_fwd(x, w16, emb)           # noqa: E731
                out = run()
                torch.cuda.synchronize()
                blocks = (list(out.values()) if stage else [out[0], *out[1]])
                if intact is None:
                    intact = blocks
                err = max(cs.rel_err(a, b) for a, b in zip(blocks, intact))
                print(json.dumps({"variant": name, "round": rnd, "points": n,
                                  "stage_ms": cs.stage_ms(run, args.kernel + "_", iters=10),
                                  "ms": cs.time_ms(run, 10), "rel_err_vs_intact": err}),
                      flush=True)
    finally:
        fft._entries = entry
    print(card)
    return 0 if identical else 1


if __name__ == "__main__":
    sys.exit(main())
