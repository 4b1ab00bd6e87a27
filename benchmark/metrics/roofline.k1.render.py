"""K1 at f32 weights (fused_field_kernel), full and density: the traced frames' launches' bounds over their device time."""

from benchmark import readers

LAYER = "kernels (kernels/fused_field_train, kernels/fused_field)"
MOVES = "render_rays_per_s"
UNIT = "%"


def read(ctx: dict) -> float | None:
    return readers.roofline(ctx, "k1")
