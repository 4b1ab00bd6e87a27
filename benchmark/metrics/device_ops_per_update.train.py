"""Device operations (kernels, copies, fills) per traced update."""

from benchmark import readers

LAYER = "host path (train/step, render/renderer)"
MOVES = "train_rays_per_s"
UNIT = "ops/update"


def read(ctx: dict) -> float | None:
    return readers.device_ops_per_unit(ctx)
