"""Spans, a timeout and the profiler trace.

Counterpart of ibl_nerf_tpu/utils/timing.py: a `timeout` decorator
(SIGALRM) and `profile_trace`, which records a torch.profiler trace
where JAX's records a jax.profiler one. The port also names its layers
in such a trace: `span(name)` around each layer boundary is a
`record_function` range while spans are on (`spans_on`, which
`profile_trace` enters) and a shared null context otherwise, so a run
with spans off pays one flag test a span. `SPANS` lists every name the
program enters, as `layer.part`.
"""

from __future__ import annotations

import contextlib
import functools
import os
import signal

import torch

from ibl_nerf_tpu_torch.utils.device import resolve_device

TRACE_NAME = "trace.json"

SPANS = (
    # the train step (train/step.py); train.update is the root of an update
    "train.update", "train.forward", "train.backward", "train.optimizer",
    "train.depth_volume",
    # the renderer (render/renderer.py)
    "render.coarse", "render.importance", "render.fine", "render.aux_heads",
    "render.normal", "render.shading", "render.depth_head",
    # inside render.shading under Monte-Carlo shading: the incident marches, the BRDF sums
    "render.mc_incident", "render.mc_brdf",
    # the host wrappers of the kernels' launches (kernels/)
    "kernel.k1", "kernel.k2", "kernel.k3",
    # the render path (eval/render_path.py); render_path.frame is the root of a frame
    "render_path.frame", "render_path.setup", "render_path.chunks", "render_path.export",
)

_NAMES = frozenset(SPANS)
_NULL = contextlib.nullcontext()
_on = False


def span(name: str, unit=None):
    """A context manager around one layer's part: the profiler range
    `name` while spans are on, with `unit` (the update's step or the
    frame's pose index, given on root spans) as its argument; the shared
    null context while they are off. Raises ValueError for a name not in
    SPANS while spans are on."""
    if not _on:
        return _NULL
    if name not in _NAMES:
        raise ValueError(f"span {name!r} is not in timing.SPANS")
    return torch.autograd.profiler.record_function(name, None if unit is None else str(unit))


@contextlib.contextmanager
def spans_on():
    """Spans on over the block (for every thread of the process), then
    as they were."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before


def timeout(seconds: int):
    """SIGALRM-based timeout decorator (main thread only)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            def handler(signum, frame):
                raise TimeoutError(f"{fn.__name__} timed out after {seconds}s")

            old = signal.signal(signal.SIGALRM, handler)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)

        return wrapper

    return deco


@contextlib.contextmanager
def profile_trace(logdir: str, device=None):
    """torch.profiler over the block, with the program's spans on, written
    as a Chrome trace to `{logdir}/trace.json`. On CUDA (the default) it
    records the host ops, the spans and every kernel the card ran, the
    port's own kernels by their CUDA symbols; with device="cpu" the host
    ops and spans only. Raises when CUDA is meant and absent rather than
    tracing the CPU alone. Yields the profiler, whose `key_averages()` sum
    the trace by name."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof, spans_on():
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))
