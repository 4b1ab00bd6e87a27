"""Traffic kind `train_updates`: training updates of the port's train step.

The step is `train/step.TrainStep`, built as `train/loop.train` builds it
from the configuration's flags, at the phase of update `update`: its loss
terms, and every optimizer group past the updates it waits for, as in a
run that reached that update. The optimizer's moments and counts are
fresh (a restored run's moments are not made here): from zero moments at
a late count, Adam's first steps would be about three times lr in every
element. Each
update's draws (merged pixels, jitter, importance uniforms, the
depth-volume pass's) are made here from the seed and passed as `draws=`.
Set-up runs the first `checked_updates` updates through the window's own
call and feed, keeping what the comparison needs, then warms up to
`warmup_updates`. The window runs updates until `seconds` have passed,
with a CUDA event at every update boundary and the scalars read to the
host every `summary_step` updates, as the training loop reads them.

Parameters: weights (`inputs.make_variables`), update, checked_updates,
warmup_updates, traced_updates.
"""

from __future__ import annotations

import math
import time
from argparse import Namespace
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

def load_lut(path: str, device) -> torch.Tensor:
    """The split-sum BRDF table as stored (uint8 RGB), in [0, 1]."""
    lut = np.load(REPO / path)
    return torch.from_numpy(lut.astype(np.float32) / 255.0).to(device)


def program_namespace(args: dict) -> Namespace:
    """The training CLI's namespace: its parser's defaults under the
    configuration's flags."""
    from ibl_nerf_tpu_torch.cli.config import build_parser

    ns = build_parser().parse_args([])
    for k, v in args.items():
        setattr(ns, k, v)
    return ns


def load_kernels(args: dict, device) -> None:
    """Build (first run) or load the libraries of the kernels the
    configuration launches."""
    if device.type != "cuda":
        return
    from ibl_nerf_tpu_torch.kernels import build as kernel_build

    names = (("fused_field",) if args["use_pallas"] else ()) + (
        ("fused_field_train",) if args["use_pallas_train"] else ())
    kernel_build.build(names)
    for name in names:
        kernel_build.load(name)


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device, phases):
        from benchmark import inputs
        from benchmark.reference import nerf as ref
        from ibl_nerf_tpu_torch.render import renderer
        from ibl_nerf_tpu_torch.train import loop
        from ibl_nerf_tpu_torch.train.losses import resolve_phase
        from ibl_nerf_tpu_torch.train.step import (build_optimizer, init_train_state,
                                                   make_train_step)
        phases.done("imports")
        args = config["args"]
        self.args, self.traffic, self.seed, self.device = args, traffic, seed, device
        self.inputs, self.ref, self.renderer = inputs, ref, renderer
        load_kernels(args, device)
        phases.done("kernels")

        self.scene = inputs.make_scene(args, config["scene"], seed, device)
        self.lut = load_lut(config["brdf_lut"], device)
        phases.done("scene")
        self.variables0 = inputs.make_variables(args, seed, device, traffic["weights"])
        phases.done("weights")

        ns = program_namespace(args)
        fcfg = loop.field_config_from_args(ns)
        rcfg = loop.render_config_from_args(ns, fcfg)
        lcfg = loop.loss_config_from_args(ns)
        self.update = traffic["update"]
        phase = resolve_phase(self.update, lcfg)
        optimizer = build_optimizer(
            self.variables0, lrate=ns.lrate, lrate_decay=ns.lrate_decay, lcfg=lcfg,
            group_lr_overrides={"env_map": ns.lrate_env_map},
            normal_feeds_shading=ns.calculating_normal_type == "inferred_normal_map")
        self.state = init_train_state(self.variables0, optimizer, step=self.update)
        self.counts = {name: 0 for name in optimizer.groups}
        for name, opt in optimizer.groups.items():
            self.state.opt_state[name].seen = opt.delay
        sc = self.scene
        self.step = make_train_step(
            rcfg, lcfg, phase, optimizer, {"brdf_lut": self.lut}, sc["height"], sc["width"],
            args["N_rand"], prior_irradiance_mean=sc["prior_irradiance_mean"],
            near=sc["near"], far=sc["far"], precrop=self.update < args["precrop_iters"],
            precrop_frac=args["precrop_frac"], merged_sampling=not args["no_batching"],
            n_depth_random_volume=args["N_depth_random_volume"], patch=False)
        self.volume = phase.depth_loss_on
        self.gen = inputs.generator(seed, "draws", device)
        phases.done("program")

        # the checked updates, then the warm-up
        self.checked_draws, self.losses = [], []
        names = [k for k, _ in ref.leaves(self.state.variables)]
        for i in range(traffic["warmup_updates"]):
            draws = self.draw()
            _, scalars = self.step(self.state, self.scene["arrays"], draws=draws)
            if i < traffic["checked_updates"]:
                self.checked_draws.append(draws)
                self.losses.append(float(scalars["loss_total"]))
            if i == 0:
                mu = [m for g in self.state.opt_state.values() for m in g.mu]
                self.first_grad = dict(zip(names, (m.norm().item() / 0.1 for m in mu)))
            if i == traffic["checked_updates"] - 1:
                start = dict(ref.leaves(self.variables0))
                self.change = {k: (p.detach() - start[k]).norm().item()
                               for k, p in ref.leaves(self.state.variables)}
        self.sync()
        self.done = traffic["warmup_updates"]
        phases.done("warm-up")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def draw(self) -> dict:
        return self.inputs.make_draws(self.gen, self.args, self.args["N_rand"], self.scene,
                                      self.volume)

    def one(self):
        """One update, its scalars read where the training loop reads them."""
        _, scalars = self.step(self.state, self.scene["arrays"], draws=self.draw())
        read = (self.update + self.done) % self.args["summary_step"] == 0
        self.done += 1
        return {k: float(v) for k, v in scalars.items()} if read else None

    def window(self, seconds: float) -> dict:
        from benchmark import flops

        cuda = self.device.type == "cuda"
        events, failed = [], 0
        self.sync()
        t0 = time.perf_counter()
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        n = 0
        while True:
            scalars = self.one()
            n += 1
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            if scalars is not None and not math.isfinite(scalars["loss_total"]):
                failed += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        t1 = time.perf_counter()
        update_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        leaves = [p for _, p in self.ref.leaves(self.state.variables)]
        if not all(torch.isfinite(p).all() for p in leaves):
            failed += 1
        least = flops.least_seconds(flops.train_update_work(self.args, self.args["N_rand"]))
        metrics = {"train_rays_per_s": n * self.args["N_rand"] / (t1 - t0)}
        if update_ms:
            metrics["update_ms_p95"] = float(np.percentile(update_ms, 95))
        return {"attempted": n, "failed": failed, "metrics": metrics, "units": n,
                "seconds": t1 - t0, "least_unit_s": least}

    def traced(self) -> dict:
        from benchmark import trace
        from ibl_nerf_tpu_torch.kernels import fused_field as ff
        from ibl_nerf_tpu_torch.kernels import fused_field_train as fft

        n = self.traffic["traced_updates"]
        before = {**ff.LAUNCHES, **fft.LAUNCHES}
        rec = trace.LaunchRecorder(self.renderer)
        try:
            summary = trace.profile(lambda: [self.one() for _ in range(n)], n)
        finally:
            calls = rec.close()
        after = {**ff.LAUNCHES, **fft.LAUNCHES}
        return {"kind": "train", "trace": summary, "launches": calls,
                "counters": {k: after[k] - before[k] for k in after}}

    def device_info(self) -> dict:
        info = {"platform": "gpu" if self.device.type == "cuda" else self.device.type,
                "count": 1}
        if self.device.type == "cuda":
            info["kind"] = torch.cuda.get_device_name(self.device)
            info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        return info

    def reference(self, prec) -> dict:
        a = self.args
        return self.ref.train_steps(
            self.variables0, self.lut, self.scene["arrays"], self.scene, self.checked_draws,
            a, prec, self.counts,
            self.ref.lr_schedule(a["lrate"], a["lrate_decay"] * 1000.0,
                                 {"env_map": a["lrate_env_map"]}))

    def check(self) -> dict:
        """The checked updates' losses, first gradients and changes against
        the plain reference's from the same weights, scene and draws, once
        the program's state is freed."""
        prog = {"losses": self.losses, "first_grad": self.first_grad, "change": self.change}
        del self.state, self.step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.expected = self.reference(self.ref.stated(self.args))
        return compare(prog, self.expected)

    def control(self) -> dict:
        """The control's readings (after `check`): the reference one step
        below the stated precision in the program's place."""
        return compare(self.reference(self.ref.control(self.args)), self.expected)


def compare(prog: dict, ref: dict) -> dict:
    """loss: the largest relative gap of an update's loss. first_grad and
    change: over the leaves whose reference gradient is nonzero and at
    least 1e-3 of the median leaf's (a gradient nought to rounding moves
    its leaf by round-off alone under Adam), each leaf's gap between the
    program's and the reference's norms, over the larger of that leaf's
    reference norm and the median compared leaf's: the worst leaf's, and
    (`*_median`) the median leaf's, which one noisy leaf cannot move."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g_med = float(np.median(list(ref["first_grad"].values())))
    kept = [k for k, g in ref["first_grad"].items() if g > 0 and g >= 1e-3 * g_med]
    out = {"loss": loss}
    for key in ("first_grad", "change"):
        r = {k: ref[key][k] for k in kept}
        med = float(np.median(list(r.values()))) if r else 0.0
        leaf = [abs(prog[key][k] - r[k]) / max(r[k], med, 1e-30) for k in kept]
        out[key] = max(leaf, default=0.0)
        out[key + "_median"] = float(np.median(leaf)) if leaf else 0.0
    return out
