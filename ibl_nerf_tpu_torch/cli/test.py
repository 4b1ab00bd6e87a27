"""Inference, material editing and object insertion from a checkpoint.

    python -m ibl_nerf_tpu_torch.cli.test --config <scene config> [flags]

Counterpart of `python -m ibl_nerf_tpu.cli.test`, with its flags and
config files: loads the test split (the single edited or inserted frame
when editing or inserting), restores the newest port checkpoint
(`train/checkpoint`), assembles the edit parameters, renders the path
with `approximate_radiance=True` and no jitter, and exports every
buffer under `{export_basedir or logs_eval}/{expname}/testset_{step:06d}`;
`--extract_mesh` adds `mesh.obj` there. Runs on the CUDA device and
raises when there is none; it never falls back to the CPU.
"""

from __future__ import annotations

import os

from ibl_nerf_tpu_torch.cli.config import parse_with_includes
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.data.dataset import load_scene
from ibl_nerf_tpu_torch.eval.render_path import render_path
from ibl_nerf_tpu_torch.render.config import EditConfig
from ibl_nerf_tpu_torch.render.renderer import _check_supported
from ibl_nerf_tpu_torch.train import checkpoint as ckpt_lib
from ibl_nerf_tpu_torch.train.loop import (
    field_config_from_args,
    init_variables,
    loss_config_from_args,
    render_config_from_args,
)
from ibl_nerf_tpu_torch.train.step import build_optimizer, init_train_state
from ibl_nerf_tpu_torch.utils.device import resolve_device
from ibl_nerf_tpu_torch.utils.logging import load_logger
from ibl_nerf_tpu_torch.utils.mesh_extract import extract_mesh


def edit_config_from_args(args) -> EditConfig | None:
    """The edit (`--edit_intrinsic`) or insert (`--insert_object`)
    parameters, None for a plain render."""
    if args.edit_intrinsic:
        return EditConfig(
            mode="edit",
            num_objects=args.num_edit_objects,
            edit_normal=args.edit_normal,
            edit_albedo=args.edit_albedo,
            edit_albedo_by_img=args.edit_albedo_by_img,
            edit_roughness=args.edit_roughness,
            edit_roughness_by_img=args.edit_roughness_by_img,
            edit_depth=args.edit_depth,
            target_albedo=tuple(args.editing_target_albedo_list or ()),
            target_roughness=tuple(args.editing_target_roughness_list or ()),
            target_irradiance=tuple(args.editing_target_irradiance_list or ()),
        )
    if args.insert_object:
        return EditConfig(
            mode="insert",
            num_objects=args.num_insert_objects,
            target_albedo=tuple(args.inserting_target_albedo_list or ()),
            target_roughness=tuple(args.inserting_target_roughness_list or ()),
            target_irradiance=tuple(args.inserting_target_irradiance_list or ()),
        )
    return None


def restore_for_eval(args, fcfg, device, lcfg=None):
    """(state, step, logdir): the newest checkpoint of the run (or
    `--ft_path` / `--target_load_N_iter`) restored into a fresh state on
    `device`, and the update index it is named after."""
    variables = init_variables(0, args, fcfg, device)
    optimizer = build_optimizer(variables, lrate=args.lrate,
                                lrate_decay=args.lrate_decay, lcfg=lcfg)
    state = init_train_state(variables, optimizer)
    logdir = os.path.join(args.basedir, args.expname)
    path = ckpt_lib.find_checkpoint(logdir, args.ft_path, args.target_load_N_iter)
    state, _, found = ckpt_lib.restore_checkpoint(
        logdir, state, ft_path=args.ft_path, target_step=args.target_load_N_iter)
    if not found:
        raise FileNotFoundError(f"no checkpoint in {logdir}")
    return state, ckpt_lib.checkpoint_step(path, state), logdir


def run_test(args, device=None) -> dict:
    """Render (and edit or insert into) the test split from the newest
    checkpoint on `device` (CUDA unless named); returns render_path's
    buffers."""
    device = resolve_device(device)
    logger = load_logger("test")

    fcfg = field_config_from_args(args)
    rcfg = render_config_from_args(args, fcfg).replace(
        approximate_radiance=True, edit=edit_config_from_args(args),
        perturb=False, raw_noise_std=0.0)
    _check_supported(rcfg)

    editing = args.edit_intrinsic or args.insert_object
    editing_idx = None
    load_edit = ()
    if args.edit_intrinsic:
        editing_idx = args.editing_img_idx
        load_edit = tuple(
            name for name, on in [
                ("mask", True),
                ("albedo", args.edit_albedo_by_img),
                ("normal", args.edit_normal_by_img or args.edit_normal),
                ("roughness", args.edit_roughness_by_img),
                ("irradiance", args.edit_irradiance_by_img),
                ("depth", args.edit_depth),
            ] if on)
    elif args.insert_object:
        editing_idx = args.inserting_img_idx

    scene = load_scene(
        args.dataset_type, args.datadir, split="test",
        image_scale=args.image_scale,
        coarse_radiance_number=args.coarse_radiance_number,
        near_plane=args.near_plane, far_plane=args.far_plane,
        load_depth_range_from_file=args.load_depth_range_from_file,
        load_normal=(args.dataset_type == "mitsuba"),
        load_albedo=(args.dataset_type == "mitsuba"),
        load_depth=args.depth_map_from_ground_truth,
        load_edit=load_edit,
        object_insert=args.insert_object,
        editing_idx=editing_idx,
        skip=1 if editing else args.testskip,
    )
    logger.info("test scene: %d poses (%dx%d)", len(scene), scene.width, scene.height)

    state, step, _ = restore_for_eval(args, fcfg, device, loss_config_from_args(args))
    logger.info("restored step %d", step)

    export_base = args.export_basedir or os.path.join(
        os.path.dirname(args.basedir.rstrip("/")), "logs_eval")
    savedir = os.path.join(export_base, args.expname, f"testset_{step:06d}")
    consts = {"brdf_lut": load_brdf_lut(device=device)}
    results = render_path(state.variables, consts, scene, rcfg, savedir=savedir,
                          render_factor=args.render_factor)
    logger.info("exported %d buffers to %s", len(results), savedir)

    if args.extract_mesh:
        mesh_path = os.path.join(savedir, "mesh.obj")
        extract_mesh(state.variables["fine" if "fine" in state.variables else "coarse"],
                     fcfg, mesh_path, n=128, radius=float(scene.far) * 0.5)
        logger.info("extracted mesh to %s", mesh_path)
    return results


def main(argv=None, device=None):
    return run_test(parse_with_includes(argv), device=device)


if __name__ == "__main__":
    main()
