"""The share of the traced frames' window in which no operation ran on the device."""

from benchmark import readers

LAYER = "device (H100)"
MOVES = "render_rays_per_s"
UNIT = "%"


def read(ctx: dict) -> float | None:
    return readers.idle(ctx)
