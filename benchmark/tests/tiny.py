"""A small size of every cell for CPU tests: the configuration's flags with
a narrow field and few rays and samples, at float32 (the port's plain
path: no kernels run on the CPU), on a small scene."""

import time

import torch

from benchmark import harness

ARGS = {"netwidth": 64, "N_rand": 64, "N_samples": 8, "N_importance": 16, "chunk": 128,
        "N_depth_random_volume": 16, "compute_dtype": "float32", "use_pallas": False,
        "use_pallas_train": False}
SCENE = {"height": 24, "width": 32, "train_images": 2}
TRAFFIC = {"frames": 3, "checked_frames": 2, "checked_pixels": 64, "warmup_updates": 4}
OVERRIDES = {"args": ARGS, "scene": SCENE, "traffic": TRAFFIC}


def run_of(cell: str, seed: int, **args):
    """The cell's driver, set up on the CPU at the small size."""
    wl = harness.read_json(harness.BENCH / "workloads" / f"{cell}.json")
    cfg = harness.read_json(harness.BENCH / "configs" / f"{wl['config']}.json")
    config = dict(cfg, args={**cfg["args"], **ARGS, **args}, scene={**cfg["scene"], **SCENE})
    driver = harness.load_module(harness.BENCH / "traffic" / f"{wl['traffic']['kind']}.py")
    run = driver.Run(config, {**wl["traffic"], **TRAFFIC}, seed, torch.device("cpu"),
                     harness.Phases(time.perf_counter()))
    return run, wl


def execute(cell: str, seed: int, trace: bool = False) -> dict:
    return harness.execute(cell, seed, 0.5, trace, torch.device("cpu"), time.perf_counter(),
                           OVERRIDES)
