"""Operations of one test-render frame under Monte-Carlo shading, from
shapes: the yardstick of `mfu.render` in the Monte-Carlo cell.

The frame's fast path (`eval/render_path.render_path(fast=True)`) runs
the coarse pass density-only and the fine pass's full query, both at the
gradient path's dtype, then one incident march a direction: M =
`mc_samples_axis`² directions a ray, each over the coarse pass's
N_samples depths, through the full field at the sweeps' dtype. It runs no
reflected march; the ε sweeps only without ground-truth normals.
"""

from __future__ import annotations

from benchmark import flops


def render_frame_work(args: dict, rays: int, eps_normals: bool) -> list[tuple]:
    """(dtype, FLOPs) of one frame of `rays` rays."""
    f = flops.Field.from_args(args)
    grad_dt = "bf16" if args["compute_dtype"] in ("bf16_grad", "bfloat16") else "f32"
    sweep_dt = "bf16" if args["compute_dtype"] in ("bfloat16", "mixed") else "f32"
    ns, ni = args["N_samples"], args["N_importance"]
    m = args["mc_samples_axis"] ** 2
    work = (flops._query(f, rays * ns, grad_dt, full=False, grad=False)
            + flops._query(f, rays * (ns + ni), grad_dt, full=True, grad=False)
            + flops._query(f, rays * m * ns, sweep_dt, full=True, grad=False))
    if eps_normals:
        work += flops._query(f, 4 * rays * (ns + ni), sweep_dt, full=False, grad=False)
    return work
