"""The port's scene loading against the JAX package's.

`load_scene` on tests/make_synthetic_scene.py's Mitsuba scene (every
buffer it holds: images, normals, albedo, roughness, depth, irradiance,
priors, edit and insert buffers) at image_scale 1 and 0.5, and on its
colmap scene: every decoded array equal to JAX's bit for bit at scale 1
(the native decoder against cv2.imread's bytes / 255) and after the
halving (OpenCV's rounded 2x2 average, reproduced); the depth maps and
the prefiltered pyramid (float resampling, reproduced in float64) within
1e-5. Then the pyramid at the Kitchen shape, whose last level is
fractional (480 rows to 7), render_path's gt-buffer shrink (on the render
device) against `resize`, and the PNG encoder against cv2.imwrite.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.data.dataset import load_scene as j_load_scene
from ibl_nerf_tpu.data.pyramid import build_prefiltered_pyramid as j_pyramid
from ibl_nerf_tpu_torch.data import native_loader
from ibl_nerf_tpu_torch.data.dataset import SceneData, load_scene
from ibl_nerf_tpu_torch.data.pyramid import build_prefiltered_pyramid, level_size
from ibl_nerf_tpu_torch.data.resize import resize
from ibl_nerf_tpu_torch.eval.render_path import _resize_gt, save_image

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_scene import make_colmap_scene, make_scene  # noqa: E402

torch.set_num_threads(2)

RESIZE_TOL = 1e-5
MITSUBA = dict(coarse_radiance_number=3, load_depth_range_from_file=True, load_normal=True,
               load_albedo=True, load_roughness=True, load_depth=True, load_irradiance=True,
               load_priors=True, prior_type="bell",
               load_edit=("mask", "albedo", "normal", "roughness", "depth"),
               object_insert=True)
# float buffers: resampled in float on both sides, so equal within RESIZE_TOL
FLOAT_FIELDS = {"depths", "edit_depths", "object_insert_depths", "prefiltered_images"}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    return (make_scene(str(root / "mitsuba")),
            make_colmap_scene(str(root / "colmap"), h=36, w=48, n=10))


def _assert_scene_equal(out: SceneData, ref, scaled: bool):
    """Every field equal; float resampling (the pyramid, and the depth
    maps at a scale) within RESIZE_TOL."""
    resampled = FLOAT_FIELDS if scaled else {"prefiltered_images"}
    for name in SceneData.__dataclass_fields__:
        a, r = getattr(out, name), getattr(ref, name)
        if isinstance(r, np.ndarray):
            assert isinstance(a, np.ndarray) and a.shape == r.shape and a.dtype == r.dtype, name
            if name in resampled:
                np.testing.assert_allclose(a, r, atol=RESIZE_TOL, err_msg=name)
            else:
                np.testing.assert_array_equal(a, r, err_msg=name)
        else:
            assert a == r, name
    assert sorted(out.gt_buffers()) == sorted(ref.gt_buffers())
    np.testing.assert_array_equal(out.focal_matrix(), ref.focal_matrix())


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("image_scale", [1.0, 0.5])
def test_load_mitsuba_matches_jax(scenes, image_scale, split):
    kw = dict(MITSUBA, split=split, image_scale=image_scale, skip=1)
    ref = j_load_scene("mitsuba", scenes[0], **kw)
    out = load_scene("mitsuba", scenes[0], **kw)
    assert out.images.shape[1:3] == (int(40 * image_scale), int(52 * image_scale))
    assert len(out.gt_buffers()) == 15
    _assert_scene_equal(out, ref, scaled=image_scale != 1.0)


@pytest.mark.parametrize("image_scale", [1.0, 0.5])
def test_load_colmap_matches_jax(scenes, image_scale):
    for split in ("train", "test"):
        kw = dict(split=split, image_scale=image_scale, load_priors=True, prior_type="ting")
        ref = j_load_scene("colmap", scenes[1], **kw)
        out = load_scene("colmap", scenes[1], **kw)
        assert len(out) == (8 if split == "train" else 2)
        _assert_scene_equal(out, ref, scaled=image_scale != 1.0)


def test_pyramid_fractional_level_matches_jax():
    """At 480x640 and K = 3 the last level is 480/64 = 7.5 -> 7 rows by
    10 columns: OpenCV's INTER_AREA weighs fractional source rows there,
    which an integer box average (adaptive_avg_pool2d, interpolate's
    "area") does not."""
    assert level_size(480, 640, 3) == (7, 10)
    images = np.random.default_rng(0).uniform(0, 1, (2, 480, 640, 3)).astype(np.float32)
    ref = j_pyramid(images, 3)
    out = build_prefiltered_pyramid(images, 3)
    assert out.shape == ref.shape == (3, 2, 480, 640, 3) and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, atol=RESIZE_TOL)
    box = torch.nn.functional.adaptive_avg_pool2d(
        torch.from_numpy(images).permute(0, 3, 1, 2), (7, 10)).permute(0, 2, 3, 1).numpy()
    small = np.stack([resize(im, (10, 7), interpolation="area") for im in images])
    assert np.abs(box - small).max() > 1e-3
    np.testing.assert_allclose(small, np.stack([cv2.resize(im, (10, 7),
                                                           interpolation=cv2.INTER_AREA)
                                                for im in images]), atol=RESIZE_TOL)


@pytest.mark.parametrize("fx", [0.5, 0.75, 0.3])
def test_uint8_shrink_matches_opencv(fx):
    img = np.random.default_rng(1).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    np.testing.assert_array_equal(resize(img, fx=fx, fy=fx), cv2.resize(img, None, fx=fx, fy=fx))


@pytest.mark.parametrize("shape,factor", [((480, 640, 3), 2), ((481, 639, 3), 4),
                                          ((30, 41, 1), 3)])
def test_render_path_gt_shrink_matches_resize(shape, factor):
    """render_path's shrink of a pose's gt buffer, run where the frame
    renders, gives `resize(..., interpolation="area")` bit for bit, at an
    integer and at a fractional ratio."""
    stack = np.random.default_rng(3).uniform(-1, 1, (2, *shape)).astype(np.float32)
    got = _resize_gt({"normal": stack}, 1, factor, torch.device("cpu"))["normal"]
    h, w = shape[:2]
    want = resize(stack[1], (w // factor, h // factor), interpolation="area")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1, shape[-1]))


@pytest.mark.parametrize("shape", [(13, 17, 3), (13, 17), (13, 17, 1)], ids=["rgb", "gray", "gray1"])
def test_png_encoder_matches_cv2_imwrite(tmp_path, shape):
    """The port's export of a buffer and JAX's cv2.imwrite of it decode to
    the same pixels, through cv2.imread and through the native decoder."""
    img = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    save_image(str(tmp_path), "port", 0, img)
    out8 = (255 * np.clip(img, 0, 1)).astype(np.uint8)   # JAX's export
    if out8.ndim == 3 and out8.shape[-1] == 3:
        cv2.imwrite(str(tmp_path / "jax_000.png"), cv2.cvtColor(out8, cv2.COLOR_RGB2BGR))
    else:
        cv2.imwrite(str(tmp_path / "jax_000.png"), out8.squeeze())
    ours = cv2.imread(str(tmp_path / "port_000.png"), cv2.IMREAD_UNCHANGED)
    theirs = cv2.imread(str(tmp_path / "jax_000.png"), cv2.IMREAD_UNCHANGED)
    assert ours.shape == theirs.shape and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    h, w = shape[:2]
    assert native_loader.probe_png(str(tmp_path / "port_000.png"))[:2] == (h, w)
    decoded = native_loader.batch_load_png_rgb(
        [str(tmp_path / "port_000.png"), str(tmp_path / "jax_000.png")], h, w)
    np.testing.assert_array_equal(decoded[0], decoded[1])


def test_native_decoder_raises_naming_the_file(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(OSError, match="bad.png"):
        native_loader.batch_load_png_rgb([str(bad)], 2, 2)
    with pytest.raises(OSError, match="bad.png"):
        native_loader.probe_png(str(bad))
