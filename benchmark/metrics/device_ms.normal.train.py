"""The device time per update of the shading normal (the program's span
`render.normal`, both shaded passes: under ε-normals the four-offset
density sweep on K1 and the four depths' composite), from the span
sub-window; nothing where the program has no such span or the cell ran no
span sub-window."""

LAYER = "train step (train/step.TrainStep)"
MOVES = "train_rays_per_s"
UNIT = "ms/update"
SPAN = "render.normal"


def read(ctx: dict) -> float | None:
    summary = ctx.get("spans")
    if not summary or SPAN not in summary["spans"]:
        return None
    return sum(summary["spans"][SPAN]["device_ms"]) / summary["units"]
