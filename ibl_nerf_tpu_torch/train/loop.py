"""The training driver.

Counterpart of ibl_nerf_tpu/train/loop.py: the scene loads once and
moves to the device; the update indices 0..N_iter
(inclusive, N_iter + 1 updates on a fresh run) are cut into phase
segments at the staged-loss boundaries and the precrop end, with one
train step per segment; every step draws from a generator seeded with
(42 + seed, i). Every `summary_step` the scalars go to metrics.jsonl and
the collapse check; every `i_weights` a checkpoint; every `i_testset`
(past 0) a test-set render to PNGs, and where that update is a multiple
of `i_video` the rgb stack as `video_{i:06d}.avi` (`utils/video.py`);
`time_limit_in_minute` stops early; `train_info_step_time.json` closes
the run.

`--init_port_path` starts from a reference checkpoint's coarse and fine
fields, which are never re-drawn (a dead one is logged and kept);
`--ray_sample patch --no_batching` logs the neighbour depths'
smoothness; `--mesh_devices N` shards the rays over the process's first
N CUDA devices (`parallel/mesh.py`) when N divides N_rand; under a
process group (`--num_processes`, joined by cli/train.py) the data is
sharded by process and the gradients all-reduced
(`parallel/distributed.py`), and only rank 0 writes the logdir, the
scalars, the logs, the test-set renders and the train info. An unknown
compute dtype or normal type is refused before the scene loads. Where
`--use_pallas_train` is set and the K2/K3 gate refuses a phase's
configuration (`render/renderer.pallas_train_refusal`), the eager query
runs and one warning names the reason.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import replace as dataclasses_replace

import numpy as np
import torch

from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.data.dataset import load_scene
from ibl_nerf_tpu_torch.data.sampler import device_arrays_from_scene, host_arrays_from_scene
from ibl_nerf_tpu_torch.eval.render_path import render_path
from ibl_nerf_tpu_torch.models.aux_mlp import init_position_direction_mlp, init_position_mlp
from ibl_nerf_tpu_torch.models.envmap import init_envmap
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.parallel import distributed as dist_lib
from ibl_nerf_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step
from ibl_nerf_tpu_torch.render.config import RenderConfig
from ibl_nerf_tpu_torch.render.renderer import _check_supported, pallas_train_refusal
from ibl_nerf_tpu_torch.train import checkpoint as ckpt_lib
from ibl_nerf_tpu_torch.train import health
from ibl_nerf_tpu_torch.train.losses import LossConfig, resolve_phase
from ibl_nerf_tpu_torch.train.step import (
    build_optimizer,
    init_train_state,
    make_train_step,
    phase_render_config,
)
from ibl_nerf_tpu_torch.utils.device import resolve_device
from ibl_nerf_tpu_torch.utils.logging import ScalarWriter, load_logger
from ibl_nerf_tpu_torch.utils.port import load_reference_checkpoint
from ibl_nerf_tpu_torch.utils.video import export_stack_as_video

def field_config_from_args(args) -> FieldConfig:
    # netdepth_fine/netwidth_fine are accepted but unread unless
    # --use_fine_arch_flags, as in the reference
    return FieldConfig(
        depth=args.netdepth, width=args.netwidth,
        multires=args.multires, multires_views=args.multires_views,
        coarse_radiance_number=args.coarse_radiance_number,
        color_independent_to_direction=args.color_independent_to_direction,
    )


def fine_field_config_from_args(args, fcfg: FieldConfig) -> FieldConfig | None:
    """The fine network's own architecture under --use_fine_arch_flags;
    None when it shares the coarse one."""
    if not getattr(args, "use_fine_arch_flags", False):
        return None
    if args.netdepth_fine == fcfg.depth and args.netwidth_fine == fcfg.width:
        return None
    return dataclasses_replace(fcfg, depth=args.netdepth_fine, width=args.netwidth_fine)


def render_config_from_args(args, fcfg: FieldConfig) -> RenderConfig:
    return RenderConfig(
        field=fcfg,
        field_fine=fine_field_config_from_args(args, fcfg),
        n_samples=args.N_samples,
        n_importance=args.N_importance,
        perturb=args.perturb > 0,
        lindisp=args.lindisp,
        raw_noise_std=args.raw_noise_std,
        use_radiance_linear=args.use_radiance_linear,
        gamma_correct=args.gamma_correct,
        shading_mode=args.shading_mode,
        mc_samples_axis=args.mc_samples_axis,
        normal_type=args.calculating_normal_type,
        epsilon=args.epsilon_for_numerical_normal,
        epsilon_direction=args.epsilon_direction_for_numerical_normal,
        lut_coefficient=args.lut_coefficient,
        correct_depth_for_prefiltered_radiance_infer=(
            args.correct_depth_for_prefiltered_radiance_infer),
        use_gradient_for_incident_radiance=args.use_gradient_for_incident_radiance,
        depth_map_from_ground_truth=args.depth_map_from_ground_truth,
        calculate_albedo_from_gt=args.calculate_albedo_from_gt,
        calculate_roughness_from_gt=args.calculate_roughness_from_gt,
        calculate_irradiance_from_gt=args.calculate_irradiance_from_gt,
        infer_normal=args.infer_normal,
        infer_normal_at_surface=args.infer_normal_at_surface,
        infer_depth=args.infer_depth,
        infer_albedo_separate=args.infer_albedo_separate,
        infer_roughness_separate=args.infer_roughness_separate,
        infer_irradiance_separate=args.infer_irradiance_separate,
        compute_dtype=args.compute_dtype,
        use_pallas=args.use_pallas,
        use_pallas_train=args.use_pallas_train,
    )


def loss_config_from_args(args) -> LossConfig:
    return LossConfig(
        beta_render=args.beta_render,
        beta_radiance_render=args.beta_radiance_render,
        beta_albedo_render=args.beta_albedo_render,
        beta_inferred_normal=args.beta_inferred_normal,
        beta_inferred_depth=args.beta_inferred_depth,
        beta_sigma_depth=args.beta_sigma_depth,
        beta_roughness_render=args.beta_roughness_render,
        beta_prior_albedo=args.beta_prior_albedo,
        beta_prior_irradiance=args.beta_prior_irradiance,
        beta_irradiance_reg=args.beta_irradiance_reg,
        n_iter_ignore_normal=args.N_iter_ignore_normal,
        n_iter_ignore_depth=args.N_iter_ignore_depth,
        n_iter_ignore_approximated_radiance=args.N_iter_ignore_approximated_radiance,
        n_iter_ignore_prior=args.N_iter_ignore_prior,
        coarse_radiance_number=args.coarse_radiance_number,
        load_priors=args.load_priors,
        albedo_prior_type=args.albedo_prior_type,
        learn_albedo_from_oracle=args.learn_albedo_from_oracle,
        initialize_roughness=args.initialize_roughness,
        roughness_init=args.roughness_init,
        infer_normal=args.infer_normal,
        infer_normal_target=args.infer_normal_target,
        infer_depth=args.infer_depth,
        depth_map_from_ground_truth=args.depth_map_from_ground_truth,
        train_depth_from_ground_truth=args.train_depth_from_ground_truth,
        freeze_radiance=args.freeze_radiance,
        freeze_roughness=args.freeze_roughness,
    )


def init_variables(seed: int, args, fcfg: FieldConfig, device) -> dict:
    """The coarse and (with N_importance > 0) fine fields, then the aux
    heads and the environment map the flags turn on, in JAX's order, all
    drawn from one generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    variables = {"coarse": init_field_params(rng, fcfg, device)}
    if args.N_importance > 0:
        fcfg_fine = fine_field_config_from_args(args, fcfg) or fcfg
        variables["fine"] = init_field_params(rng, fcfg_fine, device)
    d, w, in_ch, in_ch_views = args.netdepth, args.netwidth, fcfg.input_ch, fcfg.input_ch_views
    for name, flag in (("depth_mlp", "infer_depth"), ("visibility_mlp", "infer_visibility")):
        if getattr(args, flag):
            variables[name] = init_position_direction_mlp(rng, d, w, in_ch, in_ch_views, 1,
                                                          device=device)
    for name, flag, out_ch in (("normal_mlp", "infer_normal", 3),
                               ("albedo_mlp", "infer_albedo_separate", 3),
                               ("roughness_mlp", "infer_roughness_separate", 1),
                               ("irradiance_mlp", "infer_irradiance_separate", 1)):
        if getattr(args, flag):
            variables[name] = init_position_mlp(rng, d, w, in_ch, out_ch, device=device)
    if args.use_environment_map:
        variables["env_map"] = init_envmap(rng, args.N_envmap_size, device)
    return variables


def _panelize(stack, max_images: int = 4):
    """Image stack (N,H,W,C)/(N,H,W) -> clipped NHWC batch for the
    TensorBoard image panels."""
    x = np.asarray(stack[:max_images], dtype=np.float32)
    if x.ndim == 3:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return np.clip(x, 0.0, 1.0)


def _load_params(args):
    return {
        "image_scale": args.image_scale,
        "coarse_radiance_number": args.coarse_radiance_number,
        "near_plane": args.near_plane,
        "far_plane": args.far_plane,
        "load_depth_range_from_file": args.load_depth_range_from_file,
        "load_priors": args.load_priors,
        "prior_type": args.prior_type,
    }


def n_updates(args) -> int:
    """The exclusive end of the update indices: N_iter + 1, or a bound
    no run reaches under `time_limit_in_minute`."""
    return 1000000 if args.time_limit_in_minute > 0 else args.N_iter + 1


def check_supported_flags(args) -> None:
    """Raise ValueError, before anything runs, for an unknown mode."""
    rcfg = render_config_from_args(args, field_config_from_args(args))
    _check_supported(rcfg.replace(approximate_radiance=True))


def _step_generator(seed: int, i: int, device) -> torch.Generator:
    """The generator of update i's draws, seeded from (42 + seed, i)."""
    state = np.random.SeedSequence((42 + seed, i)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def _init_from_port(args, variables, fcfg, scene, logger) -> dict:
    """The coarse and fine fields of the reference checkpoint at
    `--init_port_path`, in place of the drawn ones. Never re-drawn: a
    dead one (max raw sigma <= 0 over the scene probe points) is logged
    as an error and kept."""
    device = variables["coarse"]["sigma"]["w"].device
    p_coarse, p_fine, _, _ = load_reference_checkpoint(
        args.init_port_path, fcfg.coarse_radiance_number, fcfg.depth, device=device)
    variables = dict(variables, coarse=p_coarse)
    if p_fine is not None and "fine" in variables:
        variables["fine"] = p_fine
    logger.info("ported initial coarse/fine weights from %s", args.init_port_path)
    probe = health.probe_points_from_scene(scene)
    ffine = fine_field_config_from_args(args, fcfg)
    for name in ("coarse", "fine"):
        if name not in variables:
            continue
        cfg = ffine if (name == "fine" and ffine is not None) else fcfg
        _, mx = health.field_density_stats(variables[name], cfg, probe)
        if mx <= 0.0:
            logger.error(
                "ported %s field init is DEAD (max raw sigma %.3f <= 0 over %d scene "
                "probe points) -- training it cannot learn geometry. Keeping it anyway "
                "because --init_port_path pins the exact weights.", name, mx, len(probe))
    return variables


def train(args, device=None):
    """Train from `args` (the CLI's namespace) on `device`, CUDA unless
    the caller names another. Under a live process group every process
    calls this with its own device. Returns the final TrainState."""
    device = resolve_device(device)
    check_supported_flags(args)
    logger = load_logger("train")
    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)
        logger.info("autograd anomaly detection enabled")
    pid, pcount = dist_lib.process_index_and_count()
    is_main = pid == 0
    use_dist = dist_lib.process_group_active()

    # (1) data
    t0 = time.time()
    load_params = _load_params(args)
    if args.dataset_type == "mitsuba":
        load_params.update(load_normal=True, load_albedo=True,
                           load_depth=args.depth_map_from_ground_truth
                           or args.train_depth_from_ground_truth)
    scene = load_scene(args.dataset_type, args.datadir, split="train", **load_params)
    val_params = dict(load_params)
    val_params["load_priors"] = False
    if args.dataset_type == "mitsuba":
        val_params.update(load_albedo=True, load_normal=True, load_irradiance=True,
                          skip=args.testskip or 10)
    else:
        val_params["skip"] = 1
    scene_val = load_scene(args.dataset_type, args.datadir, split="test", **val_params)
    logger.info("data loaded in %.1fs: train %d, val %d imgs (%dx%d)",
                time.time() - t0, len(scene), len(scene_val), scene.width, scene.height)

    # (2) model + optimizer + restore
    logdir = os.path.join(args.basedir, args.expname)
    fcfg = field_config_from_args(args)
    rcfg = render_config_from_args(args, fcfg)
    lcfg = loss_config_from_args(args)
    seed = int(getattr(args, "seed", 0) or 0)
    variables = init_variables(seed, args, fcfg, device)
    if args.init_port_path:
        variables = _init_from_port(args, variables, fcfg, scene, logger)
    elif not args.no_init_rejection:
        variables = health.reject_dead_inits(
            seed, variables, fcfg, health.probe_points_from_scene(scene),
            fcfg_fine=fine_field_config_from_args(args, fcfg),
            min_fracpos=float(args.init_reject_fracpos), logger=logger)
    consts = {"brdf_lut": load_brdf_lut(device=device)}

    optimizer = build_optimizer(
        variables, lrate=args.lrate, lrate_decay=args.lrate_decay, lcfg=lcfg,
        group_lr_overrides={"env_map": args.lrate_env_map},
        normal_feeds_shading=args.calculating_normal_type == "inferred_normal_map")
    state = init_train_state(variables, optimizer)
    elapsed_time = 0.0
    if not args.no_reload:
        state, elapsed_time, found = ckpt_lib.restore_checkpoint(
            logdir, state, ft_path=args.ft_path, target_step=args.target_load_N_iter)
        if found:
            logger.info("restored checkpoint at step %d (elapsed %.0fs)",
                        state.step, elapsed_time)
    # state.step counts completed updates: the run resumes at the first
    # update the checkpoint does not contain
    start = int(state.step)

    # (3) logdir, on the main process only
    if is_main:
        os.makedirs(logdir, exist_ok=True)
    writer = ScalarWriter(logdir) if is_main else None

    # (4) the dataset: on the device; on the host, sharded by image,
    # under a process group
    include = ("normal", "albedo", "roughness", "depth", "prior_albedo", "prior_irradiance")
    if use_dist:
        arrays = host_arrays_from_scene(scene, include=include)
    else:
        arrays = device_arrays_from_scene(scene, include=include, device=device)

    # (5) phase segmentation over update indices start..N_iter inclusive
    n_iters = n_updates(args)
    time_limit_sec = args.time_limit_in_minute * 60 if args.time_limit_in_minute > 0 else -1.0
    boundaries = sorted({
        0, start,
        args.N_iter_ignore_approximated_radiance,
        args.N_iter_ignore_prior,
        args.N_iter_ignore_normal if args.infer_normal else 0,
        args.N_iter_ignore_depth if args.infer_depth else 0,
        args.precrop_iters,
        n_iters,
    })
    boundaries = [b for b in boundaries if start <= b <= n_iters]
    if not boundaries or boundaries[0] != start:
        boundaries.insert(0, start)
    if boundaries[-1] != n_iters:
        boundaries.append(n_iters)

    def save_ckpt(i):
        # every process calls save: rank 0 writes, the others wait for it
        path = ckpt_lib.save_checkpoint(logdir, i, state, elapsed_time)
        if is_main:
            logger.info("saved checkpoint %s", path)

    def run_testset(i, export_video=False):
        if not is_main:
            return
        testdir = os.path.join(logdir, f"testset_{i:06d}")
        results = render_path(state.variables, consts, scene_val,
                              rcfg.replace(approximate_radiance=True), savedir=testdir,
                              render_factor=args.render_factor)
        logger.info("saved test set to %s", testdir)
        coverage = health.testset_acc_coverage(results)
        if coverage is not None:
            health.check_collapse(coverage, i, logger, source="held-out testset")
            writer.write(i, {"testset_acc_coverage": coverage})
        for name in ("rgb", "albedo", "roughness", "irradiance", "radiance",
                     "target_normal_map", "depth", "specular", "diffuse"):
            if name in results:
                writer.write_images(f"testset/{name}", _panelize(results[name]), i)
        if export_video and "rgb" in results:
            path = export_stack_as_video(results["rgb"],
                                         os.path.join(logdir, f"video_{i:06d}.avi"))
            logger.info("saved video %s", path)

    # --mesh_devices N > 1 shards the rays over the first N devices of
    # this process, clamped to what it has; under a process group the
    # data is sharded by process and each samples its shard of the rays
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh_n = min(args.mesh_devices, n_dev)
    use_mesh = mesh_n > 1 and args.N_rand % mesh_n == 0
    if use_dist:
        use_mesh = False
        logger.info("multi-process: %d processes, %d devices; rays sharded over the "
                    "processes, images sharded by process", pcount,
                    len(dist_lib.global_mesh(device.type)))
    elif use_mesh:
        mesh = make_mesh([torch.device(device.type, i) for i in range(mesh_n)])
        logger.info("sharding rays over %d devices", mesh_n)
    elif args.mesh_devices > 1:
        logger.info("--mesh_devices %d: %d device(s) here and N_rand %d; training "
                    "unsharded", args.mesh_devices, n_dev, args.N_rand)

    if writer is not None and start <= 1:
        writer.write_images("gt/rgb", _panelize(scene.images), 0)
        if scene.prefiltered_images is not None:
            for lv in range(scene.prefiltered_images.shape[0]):
                writer.write_images(f"gt/rgb_prefiltered_{lv + 1}",
                                    _panelize(scene.prefiltered_images[lv]), 0)
        for name, buf in scene.gt_buffers().items():
            writer.write_images(f"gt/{name}", _panelize(buf), 0)

    # --ray_sample patch: the neighbour depths feed a logged smoothness
    # scalar; single-image sampling only
    use_patch = args.ray_sample == "patch" and args.no_batching
    if args.ray_sample == "patch" and not args.no_batching:
        logger.warning("--ray_sample patch requires --no_batching (single-image "
                       "sampling); ignoring patch mode")

    stop_training = False
    collapse_warned = False  # warn loudly once, keep logging the scalar
    refusals_warned = set()  # each reason --use_pallas_train falls back for, once
    global_step = start
    for seg_start, seg_end in zip(boundaries[:-1], boundaries[1:]):
        if stop_training or seg_start >= seg_end:
            continue
        phase = resolve_phase(seg_start, lcfg)
        if args.use_pallas_train and is_main:
            prcfg = phase_render_config(rcfg, phase)
            for f in filter(None, (prcfg.field, prcfg.field_fine)):
                reason = pallas_train_refusal(prcfg.replace(field=f))
                if reason and reason not in refusals_warned:
                    refusals_warned.add(reason)
                    logger.warning("--use_pallas_train: from update %d the gradient path "
                                   "runs the eager field query, not K2/K3 (%s)", seg_start,
                                   reason)
        precrop = seg_start < args.precrop_iters
        common = dict(prior_irradiance_mean=scene.prior_irradiance_mean, near=scene.near,
                      far=scene.far, n_depth_random_volume=args.N_depth_random_volume)
        if use_dist:
            sampler = dist_lib.HostShardedSampler(
                arrays, args.N_rand, scene.height, scene.width, precrop=precrop,
                precrop_frac=args.precrop_frac, merged=not args.no_batching, device=device)
            gstep_fn, place_state = dist_lib.make_global_train_step(
                rcfg, lcfg, phase, optimizer, consts, args.N_rand, **common)
            state = place_state(state)

            def step_call(state, i, _fn=gstep_fn, _s=sampler):
                draws = _fn.draw(device, _step_generator(seed, i, device),
                                 volume="normal" in arrays)
                return _fn(state, draws, *_s.sample(i))
        else:
            kwargs = dict(precrop=precrop, precrop_frac=args.precrop_frac,
                          merged_sampling=not args.no_batching, patch=use_patch, **common)
            if use_mesh:
                step_fn, place_state, place_arrays = make_sharded_train_step(
                    rcfg, lcfg, phase, optimizer, consts, scene.height, scene.width,
                    args.N_rand, mesh=mesh, **kwargs)
                state = place_state(state)
                arrays = place_arrays(arrays)
            else:
                step_fn = make_train_step(rcfg, lcfg, phase, optimizer, consts, scene.height,
                                          scene.width, args.N_rand, **kwargs)

            def step_call(state, i, _fn=step_fn):
                return _fn(state, arrays, generator=_step_generator(seed, i, device))
        logger.info("phase segment [%d, %d): %s", seg_start, seg_end, phase)

        for i in range(seg_start, seg_end):
            it_t0 = time.time()
            state, scalars = step_call(state, i)

            if i % args.summary_step == 0:
                scalars = {k: float(v) for k, v in scalars.items()}
                if writer is not None:
                    writer.write(i, {**scalars, "elapsed_time": elapsed_time})
                if is_main:
                    logger.info("iter %d loss %.5f", i, scalars["loss_total"])
                    if "acc_mean" in scalars and i > 0:
                        hit = health.check_collapse(scalars["acc_mean"], i,
                                                    logger if not collapse_warned else None)
                        collapse_warned |= hit

            elapsed_time += time.time() - it_t0
            global_step = i + 1

            if time_limit_sec > 0 and elapsed_time > time_limit_sec:
                logger.info("time limit reached (%.0fs)", elapsed_time)
                run_testset(i)
                save_ckpt(i)
                stop_training = True
                break

            if i % args.i_weights == 0:
                save_ckpt(i)
            if i % args.i_testset == 0 and i > 0:
                run_testset(i, export_video=i % args.i_video == 0)

    if is_main:
        with open(os.path.join(logdir, "train_info_step_time.json"), "w") as f:
            json.dump({"training_time": elapsed_time, "global_step": global_step}, f,
                      indent=4)
    if writer is not None:
        writer.close()
    return state
