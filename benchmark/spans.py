"""The span sub-window: torch.profiler over a few units of work with the
port's spans on (`utils/timing.spans_on`), reduced per span.

The program names its layers with `record_function` ranges (`timing.SPANS`).
Under the profiler's CUDA activity each range is also a device-typed
annotation event, which `trace.reduce` would count as busy device time, so
the traced sub-window keeps spans off and this one runs after it over the
same units. Its reduction gives, per span and per unit (an update or a
frame: one root span each), the device time and operations of the kernels
the span launched, the span's host time, and the device's idle time inside
it. A kernel belongs to every span open when its launching host op began;
a kernel launched in the backward also belongs to the spans of the forward
op that made its autograd node, so a layer's time includes its backward.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> [--cost 1]

sets up a cell as a run does, takes its window, the traced sub-window and
then this one, and prints the traced sub-window's per-layer metrics, the
readings of `METRICS` and the split of the idle time as one JSON line.
With `--cost 1` it first times four windows with spans off, on, on, off.
"""

from __future__ import annotations

import bisect
import sys
import time
from typing import NamedTuple

import torch

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import trace  # noqa: E402

# each root span (one unit of work) and its children, which split it
ROOTS = {
    "train.update": ("train.forward", "train.backward", "train.optimizer"),
    "render_path.frame": ("render_path.setup", "render_path.chunks", "render_path.export"),
}
# spans read together: a kernel under several of them counts once
GROUPS = {"+aux_heads": ("render.aux_heads", "render.depth_head", "train.depth_volume")}
CHILDREN = "+children"
BACKWARD = "autograd::engine::evaluate_function:"

# per-layer metrics of these spans: (unit, layer, moves, reading, entry);
# an "idle" reading is the entry's idle time over the sub-window's, in %,
# a "device_ms" reading the entry's device time per unit
HOST_PATH = "host path (train/step, render/renderer)"
METRICS = {
    "idle.forward.train": ("%", HOST_PATH, "train_rays_per_s", "idle", "train.forward"),
    "idle.backward.train": ("%", HOST_PATH, "train_rays_per_s", "idle", "train.backward"),
    "idle.optimizer.train": ("%", HOST_PATH, "train_rays_per_s", "idle", "train.optimizer"),
    "device_ms.aux_heads.train": ("ms/update", "train step (train/step.TrainStep)",
                                  "train_rays_per_s", "device_ms", "+aux_heads"),
    "idle.chunks.render": ("%", HOST_PATH, "render_rays_per_s", "idle",
                           "render_path.chunks"),
    "idle.export.render": ("%", "render path (eval/render_path)", "render_rays_per_s",
                           "idle", "render_path.export"),
    "device_ms.normal.render": ("ms/frame", "render path (eval/render_path)",
                                "render_rays_per_s", "device_ms", "render.normal"),
}


class Event(NamedTuple):
    """One profiled event, times in microseconds."""

    name: str
    start: float
    end: float
    device: bool            # ran on the device (kernel, copy, fill, annotation)
    thread: int
    id: int                 # correlation id: a device op's is its runtime call's
    linked: int             # device op or runtime call: the id of its innermost
                            # (non-annotation) host op, 0 where none was open
    seq: int = -1           # autograd sequence number
    fwd_thread: int = 0     # a backward op's forward thread
    annotation: bool = False  # a record_function range (on the host or the device)


def events_of(prof) -> list[Event]:
    """The profile's raw (Kineto) events, which carry the launch links on
    torch versions whose FunctionEvents drop them."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    return [Event(k.name(), (k.start_ns() - t0) * 1e-3, (k.end_ns() - t0) * 1e-3,
                  k.device_type() == cuda, k.start_thread_id(), k.correlation_id(),
                  k.linked_correlation_id(), k.sequence_nr(), k.fwd_thread_id(),
                  k.is_user_annotation())
            for k in res.events()]


def record(fn) -> list[Event] | None:
    """`fn` under the profiler with the program's spans on, between two
    device syncs (CPU ops only without a card); None where the program has
    no spans."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from ibl_nerf_tpu_torch.utils import timing

    spans_on = getattr(timing, "spans_on", None)
    if spans_on is None:
        return None
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof, spans_on():
        with torch.profiler.record_function(trace.WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    return events_of(prof)


def profile(fn, units: int) -> dict | None:
    """Run `fn` (which does `units` units of work) in the span sub-window,
    reduce it and log its table; None where the program has no spans."""
    events = record(fn)
    if events is None:
        return None
    t = time.perf_counter()
    summary = reduce(events, units)
    if summary is not None:
        summary["reduce_s"] = time.perf_counter() - t
        log_table(summary)
    return summary


class _Intervals:
    """Disjoint sorted intervals: membership and overlap in O(log n)."""

    def __init__(self, intervals):
        self.spans = trace._union(intervals)
        self.starts = [s for s, _ in self.spans]
        self.cum = [0.0]
        for s, e in self.spans:
            self.cum.append(self.cum[-1] + e - s)

    def holds(self, t: float) -> bool:
        k = bisect.bisect_right(self.starts, t) - 1
        return k >= 0 and t <= self.spans[k][1]

    def below(self, t: float) -> float:
        """Their length before `t`."""
        k = bisect.bisect_right(self.starts, t) - 1
        if k < 0:
            return 0.0
        return self.cum[k] + min(t, self.spans[k][1]) - self.spans[k][0]

    def within(self, a: float, b: float) -> float:
        return self.below(b) - self.below(a)

    def total(self) -> float:
        return self.cum[-1]


def reduce(events, units: int) -> dict | None:
    """Per span name (and `GROUPS`, and `CHILDREN`: the root's children
    together), lists over the units of: device_ms, device_ops (the device
    ops the entry launched), host_ms (its host intervals' length) and
    idle_ms (the device's idle time within them); the sub-window's
    window_ms, busy_ms and idle_ms, outside_idle_ms (idle outside every
    child of the root) and busy_under_children (the share of busy time
    whose ops a child launched). None where no root span ran. Raises
    ValueError when the root spans are not `units`."""
    win = [e for e in events if e.name == trace.WINDOW and not e.device]
    w0, w1 = (win[0].start, win[0].end) if win else (
        min(e.start for e in events), max(e.end for e in events))
    host = [e for e in events if not e.device and e.name != trace.WINDOW]
    spans = [e for e in host if e.annotation]
    root = next((r for r in ROOTS if any(e.name == r for e in spans)), None)
    if root is None:
        return None
    roots = sorted((e.start, e.end) for e in spans if e.name == root)
    if len(roots) != units:
        raise ValueError(f"{len(roots)} {root} spans in a sub-window of {units} units")
    root_starts = [s for s, _ in roots]

    def unit_of(t: float) -> int | None:
        k = bisect.bisect_right(root_starts, t) - 1
        return k if k >= 0 and t <= roots[k][1] else None

    members = {name: (name,) for name in sorted({e.name for e in spans})}
    members.update({g: names for g, names in GROUPS.items()
                    if any(n in members for n in names)})
    members[CHILDREN] = ROOTS[root]
    entries = {g: _Intervals([(max(e.start, w0), min(e.end, w1)) for e in spans
                              if e.name in names and e.end > w0 and e.start < w1])
               for g, names in members.items()}

    device = [e for e in events if e.device and not e.annotation and e.end > w0
              and e.start < w1]
    busy = _Intervals([(max(e.start, w0), min(e.end, w1)) for e in device])
    gaps = [(s, e) for s, e in zip([w0] + [e for _, e in busy.spans],
                                   [s for s, _ in busy.spans] + [w1]) if e > s]
    idle = _Intervals(gaps)

    # the runtime call that launched each device op (its correlation id;
    # else the host op it names), and the forward op of each backward node
    # (by sequence number and forward thread)
    runtime, launchers = {}, {}
    forward: dict[tuple[int, int], float] = {}
    backward: dict[int, list[Event]] = {}
    for e in host:
        if e.name.startswith("cu") and not e.annotation:
            runtime.setdefault(e.id, e)
        elif e.linked == 0:
            launchers.setdefault(e.id, e)
        if e.name.startswith(BACKWARD):
            backward.setdefault(e.thread, []).append(e)
        elif e.seq >= 0:
            key = (e.seq, e.thread)
            forward[key] = min(forward.get(key, e.start), e.start)
    for nodes in backward.values():
        nodes.sort(key=lambda e: e.start)
    backward_starts = {t: [e.start for e in nodes] for t, nodes in backward.items()}

    def forward_start(h: Event) -> float | None:
        nodes = backward.get(h.thread)
        if not nodes:
            return None
        k = bisect.bisect_right(backward_starts[h.thread], h.start) - 1
        if k < 0 or h.start > nodes[k].end:
            return None
        return forward.get((nodes[k].seq, nodes[k].fwd_thread))

    out = {g: {"device_ms": [0.0] * units, "device_ops": [0] * units,
               "host_ms": [0.0] * units, "idle_ms": [0.0] * units} for g in entries}
    for g, iv in entries.items():
        for s, e in iv.spans:
            u = unit_of(s)
            if u is not None:
                out[g]["host_ms"][u] += (e - s) * 1e-3
                out[g]["idle_ms"][u] += idle.within(s, e) * 1e-3
    unlinked = 0
    child_busy = []
    for d in device:
        h = runtime.get(d.id) or (launchers.get(d.linked) if d.linked else None)
        if h is None:
            unlinked += 1
            continue
        times = [h.start]
        fwd = forward_start(h)
        if fwd is not None:
            times.append(fwd)
        u = unit_of(h.start)
        s, e = max(d.start, w0), min(d.end, w1)
        for g, iv in entries.items():
            if any(iv.holds(t) for t in times):
                if g == CHILDREN:
                    child_busy.append((s, e))
                if u is not None:
                    out[g]["device_ms"][u] += (e - s) * 1e-3
                    out[g]["device_ops"][u] += 1
    children = entries[CHILDREN]
    return {"root": root, "units": units, "window_ms": (w1 - w0) * 1e-3,
            "busy_ms": busy.total() * 1e-3, "idle_ms": idle.total() * 1e-3,
            "outside_idle_ms": (idle.total() - sum(
                idle.within(s, e) for s, e in children.spans)) * 1e-3,
            "busy_under_children": (_Intervals(child_busy).total() / busy.total()
                                    if busy.total() else None),
            "unlinked_ops": unlinked, "spans": out}


def log_table(summary: dict) -> None:
    """One `span <name> ...` line per entry (sums over the units), then the
    split of the sub-window's idle time."""
    for name, v in summary["spans"].items():
        print(f"span {name} device_ms {sum(v['device_ms']):.3f} device_ops "
              f"{sum(v['device_ops'])} host_ms {sum(v['host_ms']):.3f} idle_ms "
              f"{sum(v['idle_ms']):.3f}", file=sys.stderr, flush=True)
    w = summary["window_ms"]
    parts = {c: sum(summary["spans"].get(c, {}).get("idle_ms", [0.0]))
             for c in ROOTS[summary["root"]]}
    split = " ".join(f"{c} {100 * v / w:.3f}%" for c, v in parts.items())
    print(f"spans idle {100 * summary['idle_ms'] / w:.3f}% = {split} outside "
          f"{100 * summary['outside_idle_ms'] / w:.3f}%; busy under children "
          f"{100 * (summary['busy_under_children'] or 0.0):.3f}%; unlinked ops "
          f"{summary['unlinked_ops']}", file=sys.stderr, flush=True)


def read(ctx: dict, metric: str) -> float | None:
    """The reading of `metric` (a key of METRICS) from `ctx["spans"]`; None
    where that sub-window did not run or its spans did not."""
    summary = ctx.get("spans")
    _, _, _, kind, entry = METRICS[metric]
    if not summary or entry not in summary["spans"]:
        return None
    v = summary["spans"][entry]
    if kind == "idle":
        return 100.0 * sum(v["idle_ms"]) / summary["window_ms"]
    return sum(v["device_ms"]) / summary["units"]


def main() -> int:
    import argparse
    import contextlib
    import json

    from benchmark import harness

    t0 = time.perf_counter()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--cost", type=int, choices=(0, 1), default=0)
    a = p.parse_args()
    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    from ibl_nerf_tpu_torch.utils import timing

    device = torch.device("cuda", 0)
    bench = harness.read_json(harness.REPO / "BENCHMARK.json")
    wl = harness.read_json(harness.BENCH / "workloads" / f"{a.workload}.json")
    config = harness.read_json(harness.BENCH / "configs" / f"{wl['config']}.json")
    traffic = wl["traffic"]
    driver = harness.load_module(harness.BENCH / "traffic" / f"{traffic['kind']}.py")
    run = driver.Run(config, traffic, a.seed, device, harness.Phases(t0))
    train = hasattr(run, "one")
    unit, n = (run.one, traffic["traced_updates"]) if train else (
        run.render, traffic["traced_frames"])
    result = {"cell": a.workload, "seed": a.seed, "card": harness.card(device)}
    if a.cost:
        cost = []
        for on in (False, True, True, False):
            with timing.spans_on() if on else contextlib.nullcontext():
                w = run.window(a.seconds)
            cost.append({"spans": on, **w["metrics"]})
            harness.log(f"cost spans {'on' if on else 'off'} {w['metrics']}")
            if not train:
                run.frames.clear()
        result["cost"] = cost
    window = run.window(a.seconds)
    result["window"] = window["metrics"]
    ctx = run.traced()
    ctx.update(window=window, args=config["args"], traffic=traffic, cell=a.workload)
    result["traced"] = {m["name"]: harness.load_module(
        harness.BENCH / "metrics" / f"{m['name']}.py").read(ctx)
        for m in harness.cell_metrics(bench, a.workload, "per_layer")}
    kept = None if train else len(run.frames)
    ctx["spans"] = profile(lambda: [unit() for _ in range(n)], n)
    if kept is not None:
        del run.frames[kept:]
    s = ctx["spans"]
    result["spans"] = {k: v for k, v in s.items() if k != "spans"}
    result["span_totals"] = {k: {q: sum(x) for q, x in v.items()} for k, v in s["spans"].items()}
    result["metrics"] = {m: read(ctx, m) for m in METRICS}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
