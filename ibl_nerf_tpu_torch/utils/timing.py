"""Phase timing utilities.

Counterpart of ibl_nerf_tpu/utils/timing.py: the `time_measure` context
manager, a `timeout` decorator (SIGALRM), and `profile_trace`, which
records a torch.profiler trace where JAX's records a jax.profiler one.
"""

from __future__ import annotations

import contextlib
import functools
import os
import signal
import time

import torch

from ibl_nerf_tpu_torch.utils.device import resolve_device
from ibl_nerf_tpu_torch.utils.logging import load_logger

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def time_measure(name: str, logger_name: str = "timing"):
    logger = load_logger(logger_name)
    t0 = time.time()
    try:
        yield
    finally:
        logger.info("%s: %.3fs", name, time.time() - t0)


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
    """torch.profiler over the block, written as a Chrome trace to
    `{logdir}/trace.json`. On CUDA (the default) it records the host ops
    and every kernel the card ran, the port's own kernels by their CUDA
    symbols; with device="cpu" the host ops only. Raises when CUDA is
    meant and absent rather than tracing the CPU alone. Yields the
    profiler, whose `key_averages()` sum the trace by name."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))
