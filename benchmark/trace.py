"""The traced sub-window: torch.profiler over a few units of work, reduced
to device intervals, busy and idle time, kernel time by symbol, the
longest idle gaps and what the host ran in them.

Also records the point count of each call into the port's kernel entry
points during the sub-window (`LaunchRecorder`), from the benchmark's side
of the call, so each kernel's bound is taken at the shapes it ran.
"""

from __future__ import annotations

import time

import torch

WINDOW = "benchmark_window"


def _events(prof):
    """(name, start_us, end_us, on_device, thread) of every profiled event."""
    out = []
    for e in prof.events():
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        out.append((e.name, float(e.time_range.start), float(e.time_range.end), on_device,
                    getattr(e, "thread", 0)))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def profile(fn, units: int) -> dict:
    """Run `fn` (which does `units` units of work) under the profiler,
    between two device syncs, and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    t = time.perf_counter()
    summary = reduce(_events(prof), units)
    summary["reduce_s"] = time.perf_counter() - t
    return summary


def reduce(events, units: int) -> dict:
    """Busy and window seconds, kernel seconds by name, the device op count
    per unit, and the breakdown (the 10 longest device ops by total time,
    the 10 longest idle gaps named by the innermost host op under them)."""
    win = [e for e in events if e[0] == WINDOW and not e[3]]
    w0, w1 = (win[0][1], win[0][2]) if win else (
        min(e[1] for e in events), max(e[2] for e in events))
    device = [(n, max(s, w0), min(e, w1)) for n, s, e, on, _ in events
              if on and n != WINDOW and e > w0 and s < w1]
    by_name: dict[str, float] = {}
    for n, s, e in device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    busy = _union([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    window_s = (w1 - w0) * 1e-6
    gaps = [(s1, e0) for (_, s1), (e0, _) in zip(busy[:-1], busy[1:])]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [(n, s, e) for n, s, e, on, _ in events if not on and n != WINDOW]
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        under = [h for h in host if h[1] <= mid <= h[2]]
        name = min(under, key=lambda h: h[2] - h[1])[0] if under else "host: outside any op"
        named.append([name, (e - s) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s, "kernel_s": by_name,
            "device_ops": len(device), "units": units,
            "breakdown": {"device_ops": [[n, s] for n, s in top], "idle_gaps": named}}


class LaunchRecorder:
    """Wraps the renderer's references to the port's kernel entry points
    and records the points of each call, and whether a backward will
    follow it (grad enabled), until `close`."""

    ENTRIES = {"fused_field_apply_train": "k2", "fused_field_apply": "k1_full",
               "fused_field_density": "k1_density"}

    def __init__(self, module):
        self.module = module
        self.calls = {k: [] for k in ("k2", "k3", "k1_full", "k1_density")}
        self.saved = {}
        for attr, kind in self.ENTRIES.items():
            fn = getattr(module, attr, None)
            if fn is None:
                continue
            self.saved[attr] = fn
            setattr(module, attr, self._wrap(fn, kind))

    def _wrap(self, fn, kind):
        def call(packed, pts, *rest):
            points = pts.numel() // 3
            self.calls[kind].append(points)
            if kind == "k2" and torch.is_grad_enabled():
                self.calls["k3"].append(points)
            return fn(packed, pts, *rest)
        return call

    def close(self) -> dict:
        for attr, fn in self.saved.items():
            setattr(self.module, attr, fn)
        return self.calls
