#!/usr/bin/env python3
"""K3 by stage with one part of its reverse chain knocked out at a time.

    python3 k3_knockout.py       # from the root of a checkout, one card

Builds `ibl_nerf_tpu_torch/csrc/fused_field_train.cu` as it is and once
per variant -- a text substitution that removes one part of
`k3_delta_chain` or changes one setting of K3 -- all nvcc processes at once, then times K3 at the fine
pass's point count (512 x 192) by stage (torch.profiler, as
chip_smoke.stage_ms), every variant in turn, twice. A variant's
gradients are wrong by design (its relative error to the intact kernel
is printed to show it ran); only its time means something: what a part
costs is at most the intact chain's time minus the variant's. One JSON
line per variant and round, then the card line. Fails without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from ibl_nerf_tpu_torch.kernels import build as kb
from ibl_nerf_tpu_torch.kernels import fused_field as ff
from ibl_nerf_tpu_torch.kernels import fused_field_train as fft
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params

MMA = ("              mma16816(acc[mt][j], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);\n"
       "              mma16816(acc[mt][j + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2], b[3]);\n",
       "")
SLABS = ("    if (issued < total) {\n      const bf16_t* s = src",
         "    if (issued < 0) {\n      const bf16_t* s = src")
# variant -> substitutions of the source; what each leaves out of the chain
VARIANTS = {
    "intact": [],
    "no_products": [MMA],                      # the mma.sync of every layer
    "no_slab_loads": [SLABS],                  # the weight slabs' copies from L2
    "no_products_no_slab_loads": [MMA, SLABS],
    "no_slab_barriers": [("    cp_async_wait<kRing - 2>();\n    __syncthreads();\n    issue();",
                          "    issue();")],     # the wait and block barrier per slab
    "no_b_fragments": [("            ldsm_x4(b, slab + (nl + 8 * j + rr + 8 * (q >> 1)) * kLdSlab"
                        " + kk + 8 * (q & 1));",
                        "            b[0] = b[1] = b[2] = b[3] = j;")],
    "no_residual_masks": [("v = __ldg(reinterpret_cast<const unsigned int*>(epi.mask_g + p * kWidth + c));",
                           "v = 0x3f803f80u;")],
    "no_delta_stores": [("    store_tile(out.p[", "    if (n < 0) store_tile(out.p[")],
    "no_sines": [("return __ldg(emb.id + l) > 0.f ? t : sinf(t + __ldg(emb.phase + l));",
                  "return __ldg(emb.id + l) > 0.f ? t : t + __ldg(emb.phase + l);")],
    "ring_of_3": [("constexpr int kRing = 4;", "constexpr int kRing = 3;")],
    # the dW stage at one block per SM: no register cap, so no spill
    "dw_one_block_per_sm": [("__launch_bounds__(kThreads, 2)\n    k3_dw_gemm",
                             "__launch_bounds__(kThreads, 1)\n    k3_dw_gemm")],
}
OUT = kb.BUILD_DIR / "knockout"


def build_variants() -> dict[str, Path]:
    src = (kb.CSRC / "fused_field_train.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
    return {name: OUT / f"lib{name}.so" for name in VARIANTS}


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_knockout: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    libs = build_variants()
    entry = fft._entries
    fwd, bwd0 = entry()
    entries = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).fused_field_train_bwd_launch
        fn.restype, fn.argtypes = bwd0.restype, bwd0.argtypes
        entries[name] = fn

    cfg = FieldConfig(depth=8, width=256, coarse_radiance_number=3)
    w16 = fft.to_bf16(ff.pack_field_weights(
        init_field_params(np.random.default_rng(cs.SEED), cfg, "cuda"), cfg))
    emb = fft.emb_constants(cfg, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    n, n_out = 512 * (64 + 128), 9 + 3 * cfg.coarse_radiance_number
    pts = torch.rand((n, 1, 3), device="cuda", generator=gen) * 4 - 2
    dirs = torch.nn.functional.normalize(torch.randn((n, 3), device="cuda", generator=gen),
                                         dim=-1)
    x = ff._pack_inputs(pts, dirs)
    g = torch.randn((n, n_out), device="cuda", generator=gen) * 1e-3
    _, res = fft._launch_fwd(x, w16, emb)
    intact = None
    try:
        for rnd in range(2):
            for name, fn in entries.items():
                fft._entries = lambda fn=fn: (fwd, fn)
                run = lambda: fft._launch_bwd(x, g, res, w16, emb)   # noqa: E731
                dw = run()
                torch.cuda.synchronize()
                if intact is None:
                    intact = dw
                err = max(cs.rel_err(dw[k], intact[k]) for k in dw)
                print(json.dumps({"variant": name, "round": rnd, "points": n,
                                  "stage_ms": cs.stage_ms(run, "k3_", iters=10),
                                  "ms": cs.time_ms(run, 10), "rel_err_vs_intact": err}),
                      flush=True)
    finally:
        fft._entries = entry
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
