"""Scene dataset loading (mitsuba, colmap).

Counterpart of ibl_nerf_tpu/data/dataset.py: the same JSON contracts,
file names, Mitsuba axis flips (x and z columns negated), near/far from
min_max_depth.json x [0.9, 1.1], the prior mean from
avg_irradiance.json, and colmap's every-8th-frame test split. Each
scene loads once into dense host numpy arrays (`SceneData`); the
sampler moves them to the device.

PNGs decode through the repo's native decoder (`data/native_loader`),
RGB, float32 in [0, 1], as JAX's `cv2.imread` path gives them; depth
`.npy` files through `np.load`. At `image_scale != 1` the images are
resized with OpenCV's INTER_LINEAR as `data/resize.py` reproduces it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

from ibl_nerf_tpu_torch.data import native_loader
from ibl_nerf_tpu_torch.data.pyramid import build_prefiltered_pyramid
from ibl_nerf_tpu_torch.data.resize import resize


def _load_images(paths: list[str], scale: float = 1.0, num_workers: int = 8) -> np.ndarray:
    """(N, H, W, 3) float32 in [0, 1] of same-sized PNGs, resized by
    `scale` as cv2.resize(uint8, fx=scale, fy=scale) resizes them."""
    h, w, _ = native_loader.probe_png(paths[0])
    out = native_loader.batch_load_png_rgb(paths, h, w, n_threads=num_workers)
    if scale == 1:
        return out
    u8 = np.rint(out * 255.0).astype(np.uint8)
    return np.stack([resize(im, fx=scale, fy=scale) for im in u8]).astype(np.float32) / 255.0


def _load_npy(path: str, scale: float = 1.0) -> np.ndarray:
    arr = np.load(path)
    if scale != 1:
        arr = resize(arr.astype(np.float32), fx=scale, fy=scale)
    return arr.astype(np.float32)


@dataclasses.dataclass
class SceneData:
    """All per-scene arrays, host-side numpy, dense and stacked."""

    name: str
    split: str
    height: int
    width: int
    focal: float
    near: float
    far: float
    prior_irradiance_mean: float

    images: np.ndarray | None = None            # (N, H, W, 3)
    poses: np.ndarray | None = None             # (N, 4, 4)
    prefiltered_images: np.ndarray | None = None  # (K, N, H, W, 3)
    normals: np.ndarray | None = None
    albedos: np.ndarray | None = None
    roughness: np.ndarray | None = None         # (N, H, W, 1)
    depths: np.ndarray | None = None            # (N, H, W, 1)
    irradiances: np.ndarray | None = None
    diffuses: np.ndarray | None = None
    speculars: np.ndarray | None = None
    prior_albedos: np.ndarray | None = None
    prior_irradiances: np.ndarray | None = None

    edit_intrinsic_masks: np.ndarray | None = None
    edit_albedos: np.ndarray | None = None
    edit_normals: np.ndarray | None = None
    edit_roughnesses: np.ndarray | None = None
    edit_irradiances: np.ndarray | None = None
    edit_depths: np.ndarray | None = None

    object_insert_masks: np.ndarray | None = None
    object_insert_depths: np.ndarray | None = None
    object_insert_normals: np.ndarray | None = None

    def __len__(self):
        return 0 if self.poses is None else len(self.poses)

    @property
    def n_images(self) -> int:
        return len(self)

    def focal_matrix(self) -> np.ndarray:
        return np.array(
            [[self.focal, 0, 0.5 * self.width],
             [0, self.focal, 0.5 * self.height],
             [0, 0, 1]], dtype=np.float32)

    def gt_buffers(self) -> dict[str, np.ndarray]:
        """Name -> (N, H, W, C) map of every loaded gt buffer, under the
        per-pixel key names the renderer and the losses read."""
        pairs = {
            "normal": self.normals,
            "albedo": self.albedos,
            "roughness": self.roughness,
            "depth": self.depths,
            "irradiance": self.irradiances,
            "prior_albedo": self.prior_albedos,
            "prior_irradiance": self.prior_irradiances,
            "edit_intrinsic_mask": self.edit_intrinsic_masks,
            "edit_albedo": self.edit_albedos,
            "edit_normal": self.edit_normals,
            "edit_roughness": self.edit_roughnesses,
            "edit_irradiance": self.edit_irradiances,
            "edit_depth": self.edit_depths,
            "object_insert_mask": self.object_insert_masks,
            "object_insert_depth": self.object_insert_depths,
            "object_insert_normal": self.object_insert_normals,
        }
        return {k: v for k, v in pairs.items() if v is not None}


def _mitsuba_frame_paths(basedir, split, idx, prior_type):
    d = os.path.join(basedir, split)
    return {
        "image": f"{d}/{idx}.png",
        "normal": f"{d}/{idx}_normal.png",
        "albedo": f"{d}/{idx}_albedo.png",
        "roughness": f"{d}/{idx}_roughness.png",
        "depth": f"{d}/{idx}_depth.npy",
        "diffuse": f"{d}/{idx}_diffuse.png",
        "specular": f"{d}/{idx}_specular.png",
        "irradiance": f"{d}/{idx}_irradiance.png",
        "prior_albedo": f"{d}/{idx}_{prior_type}_r.png",
        "prior_irradiance": f"{d}/{idx}_{prior_type}_s.png",
        "edit_intrinsic_mask": f"{d}/{idx}_edit_intrinsic_mask.png",
        "edit_albedo": f"{d}/{idx}_edit_albedo.png",
        "edit_normal": f"{d}/{idx}_edit_normal.png",
        "edit_roughness": f"{d}/{idx}_edit_roughness.png",
        "edit_irradiance": f"{d}/{idx}_edit_irradiance.png",
        "edit_depth": f"{d}/{idx}_edit_depth.npy",
        "object_insert_mask": f"{d}/{idx}_insert_mask.png",
        "object_insert_depth": f"{d}/{idx}_insert_depth.npy",
        "object_insert_normal": f"{d}/{idx}_insert_normal.png",
    }


def load_mitsuba(
    basedir: str,
    split: str = "train",
    image_scale: float = 1.0,
    coarse_radiance_number: int = 3,
    near_plane: float = 1.0,
    far_plane: float = 20.0,
    load_depth_range_from_file: bool = False,
    load_image: bool = True,
    load_normal: bool = False,
    load_albedo: bool = False,
    load_roughness: bool = False,
    load_depth: bool = False,
    load_irradiance: bool = False,
    load_diffuse_specular: bool = False,
    load_priors: bool = False,
    prior_type: str = "bell",
    load_edit: tuple[str, ...] = (),   # subset of {"mask","albedo","normal","roughness","irradiance","depth"}
    object_insert: bool = False,
    skip: int = 1,
    editing_idx: int | None = None,
    num_workers: int = 8,
) -> SceneData:
    """Mitsuba synthetic scenes."""
    near, far = near_plane, far_plane
    if load_depth_range_from_file:
        with open(os.path.join(basedir, "min_max_depth.json")) as fp:
            f = json.load(fp)
        near, far = f["min_depth"] * 0.9, f["max_depth"] * 1.1

    prior_mean = 0.7
    if load_priors:
        with open(os.path.join(basedir, "avg_irradiance.json")) as fp:
            prior_mean = json.load(fp)["mean_" + prior_type]

    with open(os.path.join(basedir, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)

    if split == "train":
        skip = 1
    camera_angle_x = float(meta["frames"][0]["fov_degree"]) / 180.0 * math.pi

    oh, ow, _ = native_loader.probe_png(os.path.join(basedir, "train/1.png"))
    height = int(oh * image_scale)
    width = int(ow * image_scale)
    focal = 0.5 * width / np.tan(0.5 * camera_angle_x)

    if editing_idx is not None:
        frame_ids = [editing_idx]
        frames = [meta["frames"][editing_idx - 1]]
    else:
        frames = meta["frames"][::skip]
        frame_ids = [skip * i + 1 for i in range(len(frames))]

    want = {"image": load_image, "normal": load_normal, "albedo": load_albedo,
            "roughness": load_roughness, "depth": load_depth,
            "irradiance": load_irradiance,
            "diffuse": load_diffuse_specular, "specular": load_diffuse_specular,
            "prior_albedo": load_priors, "prior_irradiance": load_priors,
            "edit_intrinsic_mask": "mask" in load_edit,
            "edit_albedo": "albedo" in load_edit,
            "edit_normal": "normal" in load_edit,
            "edit_roughness": "roughness" in load_edit,
            "edit_irradiance": "irradiance" in load_edit,
            "edit_depth": "depth" in load_edit,
            "object_insert_mask": object_insert,
            "object_insert_depth": object_insert,
            "object_insert_normal": object_insert}

    all_paths = [_mitsuba_frame_paths(basedir, split, fid, prior_type) for fid in frame_ids]
    loaded: dict[str, np.ndarray] = {}
    for k, on in want.items():
        if not on:
            continue
        paths = [p[k] for p in all_paths]
        if k.endswith("depth"):
            loaded[k] = np.stack([_load_npy(p, image_scale)[..., None] for p in paths])
        else:
            loaded[k] = _load_images(paths, image_scale, num_workers)
        if k in ("roughness", "edit_roughness"):
            loaded[k] = loaded[k][..., 0:1]

    poses = []
    for frame in frames:
        pose = np.array(frame["transform"], dtype=np.float32)
        # Mitsuba camera forward is +Z: flip x and z basis columns.
        pose[:3, 0] *= -1
        pose[:3, 2] *= -1
        poses.append(pose)

    data = SceneData(
        name="mitsuba", split=split, height=height, width=width, focal=focal,
        near=near, far=far, prior_irradiance_mean=prior_mean,
        images=loaded.get("image"), poses=np.stack(poses, 0),
        normals=loaded.get("normal"), albedos=loaded.get("albedo"),
        roughness=loaded.get("roughness"), depths=loaded.get("depth"),
        irradiances=loaded.get("irradiance"), diffuses=loaded.get("diffuse"),
        speculars=loaded.get("specular"),
        prior_albedos=loaded.get("prior_albedo"),
        prior_irradiances=loaded.get("prior_irradiance"),
        edit_intrinsic_masks=loaded.get("edit_intrinsic_mask"),
        edit_albedos=loaded.get("edit_albedo"), edit_normals=loaded.get("edit_normal"),
        edit_roughnesses=loaded.get("edit_roughness"),
        edit_irradiances=loaded.get("edit_irradiance"),
        edit_depths=loaded.get("edit_depth"),
        object_insert_masks=loaded.get("object_insert_mask"),
        object_insert_depths=loaded.get("object_insert_depth"),
        object_insert_normals=loaded.get("object_insert_normal"),
    )
    if data.images is not None and coarse_radiance_number > 0:
        data.prefiltered_images = build_prefiltered_pyramid(
            data.images, coarse_radiance_number, image_scale)
    return data


def load_colmap(
    basedir: str,
    split: str = "train",
    image_scale: float = 1.0,
    coarse_radiance_number: int = 3,
    near_plane: float = 0.5,
    far_plane: float = 20.0,
    load_priors: bool = False,
    prior_type: str = "ting",
    num_workers: int = 8,
    **_,
) -> SceneData:
    """Real scenes from colmap: every-8th-frame test split,
    transforms.json camera model."""
    prior_mean = 0.7
    if load_priors:
        with open(os.path.join(basedir, "avg_irradiance.json")) as fp:
            prior_mean = json.load(fp)["mean_" + prior_type]

    with open(os.path.join(basedir, "transforms.json")) as fp:
        meta = json.load(fp)

    camera_angle_x = float(meta["camera_angle_x"])
    oh, ow = meta["h"], meta["w"]
    height = int(oh * image_scale)
    width = int(ow * image_scale)
    focal = 0.5 * width / np.tan(0.5 * camera_angle_x)

    n_total = len(meta["frames"])
    if split == "train":
        idx = [i * 8 + j + 1 for i in range(n_total // 8 + 1) for j in range(7)]
    else:
        idx = [i * 8 for i in range(n_total // 8 + 1)]
    index_list = [i for i in idx if i < n_total]

    frames = [meta["frames"][i] for i in index_list]
    names = [os.path.split(frame["file_path"])[-1] for frame in frames]
    image_dir = os.path.join(basedir, "images")

    def load(suffix=""):
        return _load_images([os.path.join(image_dir, f"{n[:-4]}{suffix}.png" if suffix else n)
                             for n in names], image_scale, num_workers)

    data = SceneData(
        name="colmap", split=split, height=height, width=width, focal=focal,
        near=near_plane, far=far_plane, prior_irradiance_mean=prior_mean,
        images=load(),
        poses=np.stack([np.array(f["transform_matrix"], dtype=np.float32) for f in frames]),
        prior_albedos=load(f"_{prior_type}_r") if load_priors else None,
        prior_irradiances=load(f"_{prior_type}_s") if load_priors else None,
    )
    if coarse_radiance_number > 0:
        data.prefiltered_images = build_prefiltered_pyramid(
            data.images, coarse_radiance_number, image_scale)
    return data


def load_scene(dataset_type: str, basedir: str, **kwargs) -> SceneData:
    if dataset_type == "mitsuba":
        return load_mitsuba(basedir, **kwargs)
    if dataset_type == "colmap":
        return load_colmap(basedir, **kwargs)
    raise ValueError(f"unknown dataset type {dataset_type}")
