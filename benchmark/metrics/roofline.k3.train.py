"""K3 (k3_* kernels): the traced updates' launches' bounds over their device time."""

from benchmark import readers

LAYER = "kernels (kernels/fused_field_train, kernels/fused_field)"
MOVES = "train_rays_per_s"
UNIT = "%"


def read(ctx: dict) -> float | None:
    return readers.roofline(ctx, "k3")
