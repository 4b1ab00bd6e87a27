"""Operations of one training update with ε-normals, from shapes: the
yardstick of `mfu.train` in the ε-normal cell.

The update is `flops.train_update_work`'s, plus each shaded pass's
ε-normal sweep: four no-grad density-only queries, offset by ±ε along the
pixel's right and up vectors, over every sample of the pass, at f32
weights (K1 density under bf16_grad). Training shades the coarse pass
(N_samples) and the fine pass (N_samples + N_importance), so an update
sweeps 4 · N_rand · (2 · N_samples + N_importance) points.
"""

from __future__ import annotations

from benchmark import flops


def sweep_points(args: dict, n_rand: int) -> int:
    """The density points of one update's ε sweeps."""
    return 4 * n_rand * (2 * args["N_samples"] + args["N_importance"])


def train_update_work(args: dict, n_rand: int) -> list[tuple]:
    """(dtype, FLOPs) of one update: `flops.train_update_work` and the
    sweeps."""
    return flops.train_update_work(args, n_rand) + flops._query(
        flops.Field.from_args(args), sweep_points(args, n_rand), "f32", full=False, grad=False)
