"""What the per-layer metrics' readers share: the step's share of the
chip's peak, a kernel's share of its roofline, the device's idle share
and its operations per unit of work, from a run's window and traced
sub-window (`harness.execute` builds the context)."""

from __future__ import annotations

import re

from benchmark import flops

# kernel symbols (as the profiler names them) and the recorder's calls of
# each kernel, with the program's launch counter that must agree
KERNELS = {
    "k2": (r"\bk2_\w+", ("k2",), {"k2": "fused_field_train_fwd"}),
    "k3": (r"\bk3_\w+", ("k3",), {"k3": "fused_field_train_bwd"}),
    "k1": (r"\bfused_field_kernel\b", ("k1_full", "k1_density"),
           {"k1_full": "fused_field_apply", "k1_density": "fused_field_density"}),
}


def mfu(ctx: dict) -> float | None:
    """The least time of the window's work at the data-sheet peaks over its
    measured time, in %."""
    w = ctx["window"]
    if not w["units"]:
        return None
    return 100.0 * w["least_unit_s"] * w["units"] / w["seconds"]


def bound_seconds(f: flops.Field, call: str, points: int) -> float:
    if call == "k2":
        return flops.k2_bound(f, points).seconds
    if call == "k3":
        return flops.k3_bound(f, points).seconds
    return flops.k1_bound(f, points, density_only=call == "k1_density").seconds


def roofline(ctx: dict, kernel: str) -> float | None:
    """The summed least time of the sub-window's launches of `kernel`, at
    their shapes, over the device time of its symbols, in %. None where the
    kernel did not run or the recorded calls disagree with the program's
    launch counters."""
    pattern, calls, counters = KERNELS[kernel]
    launches = ctx["launches"]
    if any(len(launches[c]) != ctx["counters"].get(counters[c], -1) for c in calls):
        return None
    f = flops.Field.from_args(ctx["args"])
    bound = sum(bound_seconds(f, c, n) for c in calls for n in launches[c])
    seconds = sum(s for name, s in ctx["trace"]["kernel_s"].items() if re.search(pattern, name))
    if bound == 0 or seconds == 0:
        return None
    return 100.0 * bound / seconds


def idle(ctx: dict) -> float | None:
    t = ctx["trace"]
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def device_ops_per_unit(ctx: dict) -> float | None:
    t = ctx["trace"]
    return t["device_ops"] / t["units"] if t["units"] else None
