"""The device time per frame of the Monte-Carlo incident marches (the
program's span `render.mc_incident`: directions, points, the K1 launch and
the composite), from the span sub-window; nothing where the program has
no such span."""

LAYER = "render path (eval/render_path)"
MOVES = "render_rays_per_s"
UNIT = "ms/frame"
SPAN = "render.mc_incident"


def read(ctx: dict) -> float | None:
    summary = ctx.get("spans")
    if not summary or SPAN not in summary["spans"]:
        return None
    return sum(summary["spans"][SPAN]["device_ms"]) / summary["units"]
