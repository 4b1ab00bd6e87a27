"""The benchmark of the PyTorch/CUDA port ibl_nerf_tpu_torch.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up (imports, kernel build or load, scene, weights, warm-up) is
logged phase by phase on standard error; then the measured window; with
`--trace 1` a profiled sub-window for the per-layer metrics; then the
comparison with the plain reference, each number beside its limit on
standard error. The last line of standard output is the result object.
Exits non-zero, printing no result, without a CUDA card, when JAX or the
JAX package was loaded, or on any error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args()

    import torch

    from benchmark import harness

    wl = harness.read_json(harness.BENCH / "workloads" / f"{a.workload}.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        harness.log(f"needs {wl['chips']} CUDA device(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    device = torch.device("cuda", 0)
    result = harness.execute(a.workload, a.seed, a.seconds, bool(a.trace), device, T0)
    result["card"] = harness.card(device)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"loaded in this process: {', '.join(found)}")
        return 3
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
