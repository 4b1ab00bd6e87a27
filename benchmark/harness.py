"""The generic run: set-up, the measured window, the traced sub-window, the
check against the plain reference, and the result line.

It knows no cell, configuration, traffic kind or metric by name. A cell is
`workloads/<cell>.json`: its configuration (`configs/<config>.json`), its
traffic parameters, whose `kind` names the driver `traffic/<kind>.py`, and
the limit of each number its comparison judges (the driver's `check`
reads more numbers than a cell may judge). The metrics it reports are those
`BENCHMARK.json` lists for it; each per-layer metric is read by
`metrics/<metric>.py`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ibl_nerf_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file, whatever characters its name has."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Phases:
    """Seconds of each set-up phase since the process started, logged as
    each ends."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0
        self.seconds: dict[str, float] = {}

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now
        log(f"setup {name} {self.seconds[name]:.3f} s")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of `section` that `cell` reports: those that list it,
    and those without a list whose moved end-to-end metric it reports."""
    e2e = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")} if (
        section == "per_layer") else set()
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def card(device) -> dict:
    """The card's name, count and power limit (nvidia-smi), for every
    share a run reports."""
    import subprocess

    import torch

    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                            f"--id={device.index or 0}"], capture_output=True, text=True,
                           timeout=60)
    return {"name": torch.cuda.get_device_name(device), "count": 1,
            "power_limit": limit.stdout.strip() or "not read"}


def execute(cell: str, seed: int, seconds: float, trace: bool, device, t0: float,
            overrides: dict | None = None) -> dict:
    """One run of `cell`; returns the result object. `overrides` (tests
    only) replaces configuration arguments ("args"), scene sizes ("scene")
    and traffic parameters ("traffic")."""
    overrides = overrides or {}
    bench = read_json(REPO / "BENCHMARK.json")
    wl = read_json(BENCH / "workloads" / f"{cell}.json")
    cfg = read_json(BENCH / "configs" / f"{wl['config']}.json")
    config = dict(cfg, args={**cfg["args"], **overrides.get("args", {})},
                  scene={**cfg["scene"], **overrides.get("scene", {})})
    traffic = {**wl["traffic"], **overrides.get("traffic", {})}
    driver = load_module(BENCH / "traffic" / f"{traffic['kind']}.py")

    phases = Phases(t0)
    run = driver.Run(config, traffic, seed, device, phases)
    setup_s = time.perf_counter() - t0
    log(f"setup total {setup_s:.3f} s")

    window = run.window(seconds)
    result: dict = {"correct": False, "attempted": window["attempted"],
                    "failed": window["failed"], "metrics": {}}
    if trace:
        ctx = run.traced()
        ctx.update(window=window, args=config["args"], traffic=traffic, cell=cell)
        for m in cell_metrics(bench, cell, "per_layer"):
            value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else window["metrics"].get(m["name"])
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = run.device_info()
    if trace:
        device_info.update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["window_s"])
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["device"] = device_info
    result["phases_s"] = phases.seconds

    readings = run.check()
    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in wl["limits"].items()}
    result["correct"] = bool(window["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    return result
