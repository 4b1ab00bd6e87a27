"""The whole update's share of the chip's peak: the least time of its field and head queries at their dtypes' data-sheet rates over the window's time per update."""

from benchmark import readers

LAYER = "train step (train/step.TrainStep)"
MOVES = "train_rays_per_s"
UNIT = "%"


def read(ctx: dict) -> float | None:
    return readers.mfu(ctx)
