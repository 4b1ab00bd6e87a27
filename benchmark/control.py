"""The readings that the limits of a cell's comparison are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 5] \
        [--control 1] [--fault half_batch]

For each seed, in one process: the cell's set-up (and, for a traffic kind
that needs answers, a window of `--seconds`), then the numbers the run
compares (the program against the plain reference: the lower readings)
and, with `--control 1`, the same numbers for the control, the reference
one step below the configuration's precision in the program's place (the
upper readings). `--fault` plants one of `faults.py`'s faults under the
timed path first. One JSON line a seed. The benchmark's runs do not run
this; it needs a CUDA card.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import argparse

    import torch

    from benchmark import faults, harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--fault", default="")
    a = p.parse_args()
    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    device = torch.device("cuda", 0)
    wl = harness.read_json(harness.BENCH / "workloads" / f"{a.workload}.json")
    config = harness.read_json(harness.BENCH / "configs" / f"{wl['config']}.json")
    driver = harness.load_module(harness.BENCH / "traffic" / f"{wl['traffic']['kind']}.py")
    if a.fault:
        {**faults.TRAIN, **faults.RENDER}[a.fault]()
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        run = driver.Run(config, wl["traffic"], seed, device, harness.Phases(t0))
        window = run.window(a.seconds)
        peak = torch.cuda.max_memory_allocated(device)
        readings = run.check()
        line = {"seed": seed, "fault": a.fault or None, "readings": readings,
                "units": window["units"], "memory_peak_bytes": peak}
        if a.control:
            line["control"] = run.control()
        for key in ("gaps", "control_gaps"):
            if hasattr(run, key):
                line[key] = getattr(run, key)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
