"""The smoke's two train steps timed in two checkouts in turns, on one card.

    python3 step_turns.py --parent DIR [--rounds 2]

DIR holds an earlier checkout of the repo (e.g. `git archive <commit>`
unpacked under the git-ignored `build/`). Each round runs one process in
the parent, two in this checkout, one in the parent again (parent,
change, change, parent); each process builds its checkout's kernels,
then times the smoke's `bf16_grad` train step (chip_smoke.train_config:
K2, K3 and K1 full at f32 weights) and its `mixed` step (K1 at bf16
weights, the eager f32 gradient path), each after its warm-up steps, in
windows of steps by the host clock ending in a device sync. It prints one
JSON line per process, a summary of the spread per checkout and step,
then the card's name and power limit. Both checkouts' `chip_smoke.py`
provide the setup, so the steps are each checkout's own.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

WINDOWS, WINDOW_STEPS = 3, 10


def worker() -> None:
    """In the checkout of the working directory: both steps' ms per step,
    window by window, as one JSON line."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
    from ibl_nerf_tpu_torch.kernels import build as kernel_build
    from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
    from ibl_nerf_tpu_torch.train import build_optimizer, init_train_state, make_train_step
    from ibl_nerf_tpu_torch.train.step import _leaves

    kernel_build.build()
    cfg = FieldConfig(depth=8, width=256, coarse_radiance_number=3)
    consts = {"brdf_lut": load_brdf_lut(device="cuda")}
    out = {"checkout": os.getcwd(), "loadavg": os.getloadavg()}
    for name, kw in (("bf16_grad", {}),
                     ("mixed", dict(compute_dtype="mixed", use_pallas_train=False,
                                    normal_type="normal_map_from_depth_gradient_epsilon"))):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        arrays = cs.train_scene("cuda", gen)
        rcfg, lcfg, phase = cs.train_config(cfg, **kw)
        rng = np.random.default_rng(cs.SEED)
        variables = {"coarse": init_field_params(rng, cfg, "cuda"),
                     "fine": init_field_params(rng, cfg, "cuda")}
        for v in _leaves(variables):
            v.requires_grad_(True)
        optimizer = build_optimizer(variables, lrate=5e-4, lrate_decay=500, lcfg=lcfg)
        state = init_train_state(variables, optimizer)
        step = make_train_step(rcfg, lcfg, phase, optimizer, consts, cs.TRAIN_H, cs.TRAIN_W,
                               cs.N_RAND, prior_irradiance_mean=0.7, near=2.0, far=8.0)
        for _ in range(cs.WARMUP_STEPS):
            state, _ = step(state, arrays, generator=gen)
        torch.cuda.synchronize()
        windows = []
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for _ in range(WINDOW_STEPS):
                state, _ = step(state, arrays, generator=gen)
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / WINDOW_STEPS * 1e3)
        out[name] = windows
        del state, step, optimizer, variables, arrays
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def run_in(checkout: Path) -> dict:
    """One worker process with `checkout` as its working directory and the
    first entry of its import path."""
    code = ("import runpy, sys; sys.path.insert(0, '.'); "
            "runpy.run_path(sys.argv[1], run_name='step_turns_worker')")
    proc = subprocess.run([sys.executable, "-c", code, str(Path(__file__).resolve())],
                          cwd=checkout, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"the worker in {checkout} failed: exit {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path, help="an earlier checkout")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("step_turns: no CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    runs = {"parent": {"bf16_grad": [], "mixed": []}, "change": {"bf16_grad": [], "mixed": []}}
    for rnd in range(args.rounds):
        for who in ("parent", "change", "change", "parent"):
            res = run_in(args.parent.resolve() if who == "parent" else here)
            print(json.dumps({"round": rnd, "who": who, **res}), flush=True)
            for step in ("bf16_grad", "mixed"):
                runs[who][step].append(statistics.median(res[step]))
    summary = {who: {step: {"median_ms_per_step": statistics.median(v),
                            "min": min(v), "max": max(v), "processes": len(v)}
                     for step, v in steps.items()} for who, steps in runs.items()}
    print(json.dumps({"summary": summary}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
          .stdout.strip())
    return 0


if __name__ == "step_turns_worker":
    worker()
elif __name__ == "__main__":
    sys.exit(main())
