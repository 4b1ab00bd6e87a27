"""Traffic kind `render_frames_mc`: `render_frames` under Monte-Carlo GGX
shading (`--shading_mode monte_carlo`), whose frames `cli.test` renders
through the same `eval/render_path.render_path(fast=True)`.

What changes from `render_frames`: the comparison is with
`reference/monte_carlo.py`; a frame's least time (`mfu.render`) counts the
incident marches in place of the reflected one (`flops_mc`); the traced
run also runs the span sub-window (`spans.profile`) over the same poses,
into `ctx["spans"]`; and `check` reads the program's counter
`mc_incident_points` over the checked frames: `incident_points_gap` is
|counted / asked - 1|, where a frame asks its chunks' rays (the last chunk
padded to `chunk` rays, as `render_frame` pads it) x mc_samples_axis² x
N_samples points, so a march that skips directions, samples or rays
reads above 0. A program without that counter cannot be checked here,
and the run stops at set-up.

The ground-truth buffers are made at the frame's size and stored at the
scene's, each value repeated over its render_factor² block, so that the
shrink `render_path` applies (INTER_AREA) gives back exactly the buffers
the reference reads.
"""

from __future__ import annotations

import math

from benchmark.traffic import render_frames
from benchmark.traffic.render_frames import FrameScene

COUNTER = "mc_incident_points"


class Run(render_frames.Run):
    def __init__(self, config: dict, traffic: dict, seed: int, device, phases):
        from benchmark.reference import monte_carlo
        from ibl_nerf_tpu_torch.render import renderer

        self.counters = getattr(renderer, "COUNTERS", {})
        if COUNTER not in self.counters:
            raise RuntimeError(f"the program has no counter {COUNTER}, which this cell's "
                               "check reads")
        self.stored: dict[int, dict] = {}
        super().__init__(config, traffic, seed, device, phases)
        self.ref = monte_carlo

    def stored_buffers(self, i: int) -> dict:
        """Pose i's buffers at the scene's size."""
        if i not in self.stored:
            f = self.traffic["render_factor"]
            self.stored[i] = {k: v.repeat(f, axis=1).repeat(f, axis=2)
                              for k, v in self.buffers[i].items()}
        return self.stored[i]

    def render(self) -> dict:
        i = self.next % len(self.poses)
        self.next += 1
        before = self.counters[COUNTER]
        out = self.render_path(
            self.variables, self.consts,
            FrameScene(self.scene, self.poses[i], self.stored_buffers(i)), self.rcfg,
            render_factor=self.traffic["render_factor"], chunk=self.args["chunk"], fast=True)
        out[COUNTER] = self.counters[COUNTER] - before
        self.frames.append((i, out))
        return out

    def window(self, seconds: float) -> dict:
        from benchmark import flops, flops_mc

        w = super().window(seconds)
        eps = self.rcfg.normal_type == "normal_map_from_depth_gradient_epsilon"
        w["least_unit_s"] = flops.least_seconds(
            flops_mc.render_frame_work(self.args, self.h * self.w, eps))
        return w

    def traced(self) -> dict:
        from benchmark import spans

        start = self.next
        ctx = super().traced()
        n, kept = self.traffic["traced_frames"], len(self.frames)
        self.next = start
        try:
            ctx["spans"] = spans.profile(lambda: [self.render() for _ in range(n)], n)
        finally:
            del self.frames[kept:]
        return ctx

    def check(self) -> dict:
        readings = super().check()
        a = self.args
        chunk = a["chunk"]
        asked = (math.ceil(self.h * self.w / chunk) * chunk * a["mc_samples_axis"] ** 2
                 * a["N_samples"] * len(self.picks))
        counted = sum(self.frames[j][1][COUNTER] for j, _ in self.picks)
        readings["incident_points_gap"] = abs(counted / asked - 1.0)
        return readings
