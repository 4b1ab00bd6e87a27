"""The whole frame's share of the chip's peak: the least time of its field queries at their dtypes' data-sheet rates over the window's time per frame."""

from benchmark import readers

LAYER = "render path (eval/render_path)"
MOVES = "render_rays_per_s"
UNIT = "%"


def read(ctx: dict) -> float | None:
    return readers.mfu(ctx)
