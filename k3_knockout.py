#!/usr/bin/env python3
"""K3 or K2 by stage with one part knocked out at a time.

    python3 k3_knockout.py                # K3, from the root of a checkout, one card
    python3 k3_knockout.py k2             # K2
    python3 k3_knockout.py k2 --parent OLD.cu

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

With `--parent`, the source of an earlier K2 whose entry point takes
every weight matrix transposed to [out][in] (and no slab stream) is
built too: its raw output and residuals are held against the intact
K2's bit for bit at chip_smoke's six point counts (the run exits 1 if
any differ), and the two are timed in turns at the fine pass. Fails
without CUDA, and when a substitution's text is gone from the source.
"""

from __future__ import annotations

import argparse
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
        "no_residual_stores": [("if (kRes) store_tile(res", "if (kRes && n < 0) store_tile(res")],
        "no_sines": [SINES],
    },
}
OUT = kb.BUILD_DIR / "knockout"
# the entry point of K2 before its weights became a slab stream
_PARENT_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_BIASES = ("tb", "bpf", "bfeat", "bv", "bcf", "bias")


def build_variants(variants: dict, extra: dict[str, str]) -> dict[str, Path]:
    """One library per variant of the source, and one per `extra` source
    text (name -> text), nvcc all at once."""
    src = (kb.CSRC / "fused_field_train.cu").read_text()
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
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
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


def parent_check(fn, w16, emb, gen, n_out) -> bool:
    """The intact K2 against the earlier one, bit for bit, at the smoke's
    six point counts (per block: true, or the max abs difference); then
    both timed in turns at the fine pass. Returns whether all were equal."""
    fine = 512 * (64 + 128)
    equal = {}
    for n in (1, 63, 4097, fine + 37, 512 * 64, fine):
        x, _ = inputs(n, gen, n_out)
        raw, res = fft._launch_fwd(x, w16, emb)
        raw_o, res_o = parent_forward(fn, x, w16, emb)
        torch.cuda.synchronize()
        blocks = {"raw": (raw, raw_o), **{k: (res[i], res_o[i])
                                          for i, k in enumerate(fft._RES_ORDER)}}
        equal[n] = {k: torch.equal(a, b) or (a.float() - b.float()).abs().max().item()
                    for k, (a, b) in blocks.items()}
    new = lambda: fft._launch_fwd(x, w16, emb)             # noqa: E731
    old = lambda: parent_forward(fn, x, w16, emb)          # noqa: E731
    new(), old()
    o1, n1, n2, o2 = (cs.time_ms(old, 10), cs.time_ms(new, 10), cs.time_ms(new, 10),
                      cs.time_ms(old, 10))
    identical = all(v is True for e in equal.values() for v in e.values())
    print(json.dumps({"parent_check": {"identical": identical, "per_points": equal},
                      "points": fine, "ms": [n1, n2], "parent_ms": [o1, o2]}), flush=True)
    return identical


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", nargs="?", choices=sorted(VARIANTS), default="k3")
    ap.add_argument("--parent", type=Path, help="source of an earlier K2 (k2 only)")
    args = ap.parse_args()
    if args.parent and args.kernel != "k2":
        ap.error("--parent applies to k2")
    if not torch.cuda.is_available():
        print("k3_knockout: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    extra = {"parent": args.parent.read_text()} if args.parent else {}
    libs = build_variants(VARIANTS[args.kernel], extra)
    entry = fft._entries
    fwd0, bwd0, k1_bf16 = entry()
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
        fn.restype, fn.argtypes = ctypes.c_int, _PARENT_ARGS
        identical = parent_check(fn, w16, emb, gen, n_out)
    x, g = inputs(n, gen, n_out)
    _, res = fft._launch_fwd(x, w16, emb)
    intact = None
    try:
        for rnd in range(2):
            for name, fn in entries.items():
                if stage:
                    fft._entries = lambda fn=fn: (fwd0, fn, k1_bf16)
                    run = lambda: fft._launch_bwd(x, g, res, w16, emb)   # noqa: E731
                else:
                    fft._entries = lambda fn=fn: (fn, bwd0, k1_bf16)
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
