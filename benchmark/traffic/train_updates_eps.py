"""Traffic kind `train_updates_eps`: `train_updates` under ε-normals
(`--calculating_normal_type normal_map_from_depth_gradient_epsilon`), as
IBL-NeRF's own configurations train.

What changes from `train_updates`: the comparison is with
`reference/eps_normals.py`; an update's least time (`mfu.train`) counts
the four-offset density sweep of both shaded passes (`flops_eps`); the
traced run also runs the span sub-window (`spans.profile`) over as many
more updates, into `ctx["spans"]`; and the comparison holds the fine
pass's samples.

The importance samples come from the coarse weights, which the bf16
gradient path rounds, so they move between program and reference; the
ε-normal is a difference of depths over 2ε, which reads the moved samples
1/(2ε) = 50 times larger, and the shading, loss and gradients follow it.
So the set-up records the importance samples the program drew in each
checked update (at the renderer's `sample_pdf`) and the reference marches
its fine passes on them; the samples themselves are compared with the
reference's own. `check` reads, besides `train_updates`' numbers against
that reference:

- `normal_gap`, `normal_gap_fine`: the shading normals the program's
  first checked update gave each ray of its coarse and fine pass
  (recorded at the renderer's `_estimate_normal`) against the
  reference's, from the same weights, draws and samples: each pass's
  median over the rays of ||program - reference||;
- `sample_gap`: the median over that update's importance samples of
  |program - reference's own|, in scene units;
- `eps_points_gap`: the program's counter `eps_normal_points` over the
  checked updates, |counted / asked - 1|, where an update asks 4 · N_rand
  · (2 · N_samples + N_importance) points, so a sweep that skips an
  offset, a pass or samples reads above 0. A program without that
  counter cannot be checked here, and the run stops at set-up.

Where the program's samples do not cover every checked update's batch,
every number but `eps_points_gap` reads infinite.
"""

from __future__ import annotations

import torch

from benchmark.traffic import train_updates

COUNTER = "eps_normal_points"


class Run(train_updates.Run):
    def __init__(self, config: dict, traffic: dict, seed: int, device, phases):
        from benchmark.reference import eps_normals
        from ibl_nerf_tpu_torch.render import renderer

        self.counters = getattr(renderer, "COUNTERS", {})
        if COUNTER not in self.counters:
            raise RuntimeError(f"the program has no counter {COUNTER}, which this cell's "
                               "check reads")
        eps_normals.check_supported(config["args"])
        # the counter before each checked update and after the last one: at
        # each draw, which comes before its update, and at the end of the
        # warm-up where it has no more updates than are checked; so during
        # checked update i, len(self.marks) is i + 1
        self.marks: list[int] = []
        self.samples: list[torch.Tensor] = []   # each checked update's
        self.normals: list[torch.Tensor] = []   # the first's, coarse pass then fine
        estimate, sample = renderer._estimate_normal, renderer.sample_pdf

        def recorded_normal(*args):
            normal = estimate(*args)
            if len(self.marks) == 1:
                self.normals.append(normal.detach().clone())
            return normal

        def recorded_samples(*args, **kwargs):
            z = sample(*args, **kwargs)
            if len(self.marks) <= traffic["checked_updates"]:
                self.samples.append(z.detach().clone())
            return z

        renderer._estimate_normal, renderer.sample_pdf = recorded_normal, recorded_samples
        try:
            super().__init__(config, traffic, seed, device, phases)
        finally:
            renderer._estimate_normal, renderer.sample_pdf = estimate, sample
        if len(self.marks) == traffic["checked_updates"]:
            self.marks.append(self.counters[COUNTER])
        self.ref = eps_normals

    def draw(self) -> dict:
        if len(self.marks) <= self.traffic["checked_updates"]:
            self.marks.append(self.counters[COUNTER])
        return super().draw()

    def window(self, seconds: float) -> dict:
        from benchmark import flops, flops_eps

        w = super().window(seconds)
        w["least_unit_s"] = flops.least_seconds(
            flops_eps.train_update_work(self.args, self.args["N_rand"]))
        return w

    def traced(self) -> dict:
        from benchmark import spans

        ctx = super().traced()
        n = self.traffic["traced_updates"]
        ctx["spans"] = spans.profile(lambda: [self.one() for _ in range(n)], n)
        return ctx

    def held(self) -> bool:
        """Whether the program's samples cover every checked update's
        batch, so that the reference can be held on them."""
        shape = (self.args["N_rand"], self.args["N_importance"])
        return (len(self.samples) == self.traffic["checked_updates"]
                and all(z.shape == shape for z in self.samples))

    def reference(self, prec) -> dict:
        a = self.args
        return self.ref.train_steps(
            self.variables0, self.lut, self.scene["arrays"], self.scene, self.checked_draws,
            a, prec, self.counts,
            self.ref.lr_schedule(a["lrate"], a["lrate_decay"] * 1000.0,
                                 {"env_map": a["lrate_env_map"]}), z_fine=self.samples)

    def check(self) -> dict:
        """`train_updates`' numbers against the reference held on the
        program's samples, then the normals, the samples and the counter."""
        from benchmark import flops_eps

        checked = self.traffic["checked_updates"]
        asked = checked * flops_eps.sweep_points(self.args, self.args["N_rand"])
        counted = {"eps_points_gap": abs((self.marks[checked] - self.marks[0]) / asked - 1.0)}
        if not self.held():
            return {**dict.fromkeys(UNHELD, float("inf")), **counted}
        readings = super().check()
        readings.update(normal_gaps(self.normals, self.expected["normals"]))
        readings["sample_gap"] = sample_gap(self.samples[0], self.expected["samples"])
        return {**readings, **counted}

    def control(self) -> dict:
        """The control's readings (after `check`), held on the same samples."""
        ctl = self.reference(self.ref.control(self.args))
        return {**train_updates.compare(ctl, self.expected),
                **normal_gaps(ctl["normals"], self.expected["normals"]),
                "sample_gap": sample_gap(ctl["samples"], self.expected["samples"])}


UNHELD = ("loss", "first_grad", "first_grad_median", "change", "change_median",
          "normal_gap", "normal_gap_fine", "sample_gap")


def sample_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The median over the samples of |prog - ref|."""
    return (prog - ref).abs().median().item()


def normal_gaps(prog: list[torch.Tensor], ref: list[torch.Tensor]) -> dict:
    """`normal_gap` and `normal_gap_fine` of the (coarse, fine) normals:
    each pass's median over the rays of ||prog - ref||; infinite where the
    passes or rays do not match."""
    out = {"normal_gap": float("inf"), "normal_gap_fine": float("inf")}
    if len(prog) == len(ref):
        for key, p, r in zip(out, prog, ref):
            if p.shape == r.shape:
                out[key] = torch.linalg.vector_norm(p - r, dim=-1).median().item()
    return out
