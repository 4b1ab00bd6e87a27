"""The share of the traced updates' window in which no operation ran on the device."""

from benchmark import readers

LAYER = "device (H100)"
MOVES = "train_rays_per_s"
UNIT = "%"


def read(ctx: dict) -> float | None:
    return readers.idle(ctx)
