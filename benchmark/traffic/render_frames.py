"""Traffic kind `render_frames`: whole frames through the port's
`eval/render_path.render_path(fast=True)`, one call a frame.

Poses: `test` frames on the training arc with ground-truth normal and
albedo buffers made from the seed (the evaluation CLI's test path), or
`orbit` poses about the origin without buffers, so the renderer estimates
ε normals (the trajectory CLI's). Frames cycle through `frames` poses.
Set-up renders one frame (every shape the window uses). The window
renders frames until `seconds` have passed; each call returns its buffers
on the host, so a frame ends when its call returns.

Parameters: weights (`inputs.make_variables`), poses, frames, render_factor,
checked_frames, checked_pixels, traced_frames.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.traffic.train_updates import load_kernels, load_lut, program_namespace


class FrameScene:
    """The scene interface render_path reads, for one pose."""

    def __init__(self, scene: dict, pose: np.ndarray, buffers: dict):
        self.height, self.width = scene["height"], scene["width"]
        self.focal, self.near, self.far = scene["focal"], scene["near"], scene["far"]
        self.poses = pose[None]
        self._buffers = buffers

    def gt_buffers(self) -> dict:
        return self._buffers


def poses_of(traffic: dict, scene_cfg: dict) -> np.ndarray:
    from benchmark import inputs

    n = traffic["frames"]
    if traffic["poses"] == "test":
        return inputs.arc_poses(n, scene_cfg["arc_radians"])
    theta = np.linspace(-np.pi, np.pi, n, endpoint=False)
    phi = math.radians(traffic["orbit_elevation_degrees"])
    r = traffic["orbit_radius"]
    return np.stack([inputs.look_at(np.array([r * np.sin(t) * np.cos(phi), r * np.sin(phi),
                                              r * np.cos(t) * np.cos(phi)]))
                     for t in theta])


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device, phases):
        from benchmark import inputs
        from benchmark.reference import nerf as ref
        from ibl_nerf_tpu_torch.eval.render_path import render_path
        from ibl_nerf_tpu_torch.render import renderer
        from ibl_nerf_tpu_torch.train import loop
        phases.done("imports")
        args = config["args"]
        self.args, self.traffic, self.seed, self.device = args, traffic, seed, device
        self.ref, self.renderer, self.render_path = ref, renderer, render_path
        load_kernels(args, device)
        phases.done("kernels")

        sc = config["scene"]
        f = traffic["render_factor"]
        self.h, self.w = sc["height"] // f, sc["width"] // f
        focal = 0.5 * sc["width"] / math.tan(0.5 * math.radians(sc["fov_degree"]))
        self.scene = {"height": sc["height"], "width": sc["width"], "focal": focal,
                      "near": sc["near"], "far": sc["far"]}
        self.poses = poses_of(traffic, sc)
        self.buffers = [{} for _ in self.poses]
        if traffic["poses"] == "test":
            gen = inputs.generator(seed, "scene", device)
            n = len(self.poses)
            normal = inputs.unit_normals(gen, (n, self.h, self.w), device).cpu().numpy()
            albedo = torch.rand((n, self.h, self.w, 3), generator=gen,
                                device=device).cpu().numpy()
            self.buffers = [{"normal": normal[i:i + 1], "albedo": albedo[i:i + 1]}
                            for i in range(n)]
        self.lut = load_lut(config["brdf_lut"], device)
        phases.done("scene")
        self.variables = inputs.make_variables(args, seed, device, traffic["weights"])
        phases.done("weights")

        ns = program_namespace(args)
        fcfg = loop.field_config_from_args(ns)
        rcfg = loop.render_config_from_args(ns, fcfg).replace(
            approximate_radiance=True, perturb=False, raw_noise_std=0.0)
        if traffic["poses"] != "test" and rcfg.normal_type == "ground_truth":
            rcfg = rcfg.replace(normal_type="normal_map_from_depth_gradient_epsilon")
        self.rcfg = rcfg
        self.consts = {"brdf_lut": self.lut}
        phases.done("program")
        self.frames: list[tuple[int, dict]] = []
        self.next = 0
        self.render()
        self.frames.clear()
        phases.done("warm-up")

    def render(self) -> dict:
        i = self.next % len(self.poses)
        self.next += 1
        out = self.render_path(
            self.variables, self.consts,
            FrameScene(self.scene, self.poses[i], self.buffers[i]), self.rcfg,
            render_factor=self.traffic["render_factor"], chunk=self.args["chunk"],
            fast=True)
        self.frames.append((i, out))
        return out

    def window(self, seconds: float) -> dict:
        from benchmark import flops

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.render()
        t1 = time.perf_counter()
        n = len(self.frames)
        failed = sum(not np.isfinite(out["rgb"]).all() for _, out in self.frames)
        rays = self.h * self.w
        eps = self.rcfg.normal_type == "normal_map_from_depth_gradient_epsilon"
        least = flops.least_seconds(flops.render_frame_work(self.args, rays, eps))
        return {"attempted": n, "failed": failed, "units": n, "seconds": t1 - t0,
                "least_unit_s": least,
                "metrics": {"render_rays_per_s": n * rays / (t1 - t0)}}

    def traced(self) -> dict:
        from benchmark import trace
        from ibl_nerf_tpu_torch.kernels import fused_field as ff
        from ibl_nerf_tpu_torch.kernels import fused_field_train as fft

        n = self.traffic["traced_frames"]
        kept = len(self.frames)
        before = {**ff.LAUNCHES, **fft.LAUNCHES}
        rec = trace.LaunchRecorder(self.renderer)
        try:
            summary = trace.profile(lambda: [self.render() for _ in range(n)], n)
        finally:
            calls = rec.close()
        del self.frames[kept:]
        after = {**ff.LAUNCHES, **fft.LAUNCHES}
        return {"kind": "render", "trace": summary, "launches": calls,
                "counters": {k: after[k] - before[k] for k in after}}

    def device_info(self) -> dict:
        info = {"platform": "gpu" if self.device.type == "cuda" else self.device.type,
                "count": 1}
        if self.device.type == "cuda":
            info["kind"] = torch.cuda.get_device_name(self.device)
            info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        return info

    def sample(self) -> list[tuple[int, np.ndarray]]:
        """The frames and pixels compared, drawn from the seed: up to
        `checked_frames` of the window's frames, `checked_pixels` pixels of
        each."""
        from benchmark import inputs

        gen = inputs.generator(self.seed, "sample", "cpu")
        picks = torch.randperm(len(self.frames), generator=gen)[:self.traffic["checked_frames"]]
        return [(int(j), torch.randperm(self.h * self.w, generator=gen)[
                    :self.traffic["checked_pixels"]].numpy()) for j in picks]

    def reference(self, prec) -> list[dict]:
        """The reference's exported buffers at the sampled pixels."""
        ref = self.ref
        focal = self.scene["focal"] / self.traffic["render_factor"]
        out = []
        for j, pix in self.picks:
            i = self.frames[j][0]
            c2w = torch.as_tensor(self.poses[i], device=self.device)
            rays_o, rays_d = ref.rays_full_image(self.h, self.w, focal, c2w)
            idx = torch.as_tensor(pix, device=self.device)
            gt = self.buffers[i].get("normal")
            normal = None if gt is None else torch.as_tensor(
                gt[0].reshape(-1, 3)[pix], device=self.device)
            out.append(ref.render_pixels(self.variables, self.lut, rays_o[idx], rays_d[idx],
                                         self.scene["near"], self.scene["far"], self.args,
                                         prec, normal))
        return out

    def check(self) -> dict:
        """Every exported per-ray buffer of the sampled pixels against the
        plain reference's render of the same rays: `buffer_gap`, the
        largest `rel_gap` of any buffer, and `rgb_gap`, the rendered
        colour's."""
        self.picks = self.sample()
        self.expected = self.reference(self.ref.stated(self.args))
        got = []
        for (j, pix), r in zip(self.picks, self.expected):
            out = self.frames[j][1]
            got.append({name: torch.as_tensor(
                out[name][0].reshape(self.h * self.w, *rv.shape[1:])[pix],
                device=self.device, dtype=torch.float32) for name, rv in r.items()})
        self.gaps = gaps(got, self.expected)
        return {"buffer_gap": max(self.gaps.values()), "rgb_gap": self.gaps["rgb"]}

    def control(self) -> dict:
        """The control's reading (after `check`): the reference one step
        below the stated precision in the program's place."""
        self.control_gaps = gaps(self.reference(self.ref.control(self.args)), self.expected)
        return {"buffer_gap": max(self.control_gaps.values()),
                "rgb_gap": self.control_gaps["rgb"]}


def gaps(got: list[dict], expected: list[dict]) -> dict[str, float]:
    """Each buffer's largest `rel_gap` over the sampled frames."""
    return {name: max(rel_gap(g[name], e[name]) for g, e in zip(got, expected))
            for name in expected[0]}


# The share of a frame's sampled pixels whose largest errors are set aside
# in each buffer: NeRF's last sample spans 1e10, so a ray whose last
# density is within rounding of 0 puts its leftover transmittance on that
# sample or not, and two sound computations differ there by up to the
# whole colour (the reference itself, its ray directions scaled by
# 1 + 1e-6, reads up to 8% on such a frame, from about 0.1% of its
# pixels). A wrong chunk of 2048 rays is 0.67% of a 480x640 frame.
SET_ASIDE = 0.0025


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """||prog - ref|| / ||ref|| over a frame's sampled pixels but the
    SET_ASIDE share with the largest error (a pixel finite on one side
    only counts as the largest; both non-finite, as a disparity where a
    ray hit nothing, is equal)."""
    err = (prog - ref).reshape(prog.shape[0], -1)
    a = torch.isfinite(prog).reshape(err.shape)
    b = torch.isfinite(ref).reshape(err.shape)
    both = a & b
    err = torch.where(both, err, torch.zeros_like(err))
    per_pixel = err.norm(dim=1)
    per_pixel[(a != b).any(dim=1)] = math.inf
    k = math.ceil(SET_ASIDE * per_pixel.shape[0])
    keep = torch.ones_like(per_pixel, dtype=torch.bool)
    keep[torch.topk(per_pixel, k).indices] = False
    if not torch.isfinite(per_pixel[keep]).all():
        return math.inf
    r = torch.where(both, ref.reshape(err.shape), torch.zeros_like(err))[keep]
    return (per_pixel[keep].norm() / r.norm().clamp_min(1e-12)).item()
