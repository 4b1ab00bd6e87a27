"""The port's evaluation tools against the JAX package's.

- `eval/metrics`: `mse`, `psnr`, `ssim` (textured, flat and gray images)
  and `batch_metrics` (values outside [0, 1] clipped) within 5e-5 of
  JAX's, and the port's f32 SSIM within 2e-6 of its float64 SSIM. On
  the flat pair JAX's f32 SSIM is 1.9e-5 from float64 (E[x^2] - E[x]^2
  cancels); the port takes the variances about the image means.
- `utils/video`: the AVI that `export_stack_as_video` and
  `export_as_video` write, read back by `cv2.VideoCapture`, holds the
  truncated stack bit for bit at 30 fps; an unknown file type, frames
  that are not uint8 RGB and a frame past one RIFF raise (`.mp4` and
  AVIs of many RIFFs: tests/test_torch_video.py).
- `utils/mesh_extract`: the generated marching-cubes table, and
  `marching_cubes` / `marching_tetrahedra` on one grid, bit for bit;
  the density grid within 5e-4 / 1e-3 of JAX's; `extract_mesh` end to
  end.
- `pose_spherical` and the render CLI's trajectories bit for bit.
- `cli/preprocess`: the JSON files bit for bit.
- `cli/port_checkpoint`: a synthetic reference `.tar` gives the JAX
  loader's params bit for bit, in a checkpoint named as JAX names it.
"""

import json
import os
import shutil
import struct
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.cli import preprocess as j_preprocess
from ibl_nerf_tpu.cli import render as j_render_cli
from ibl_nerf_tpu.eval import metrics as j_metrics
from ibl_nerf_tpu.models.field import FieldConfig as JFieldConfig
from ibl_nerf_tpu.models.field import init_field_params as j_init
from ibl_nerf_tpu.ops.geometry import pose_spherical as j_pose_spherical
from ibl_nerf_tpu.utils import mesh_extract as j_mesh
from ibl_nerf_tpu.utils.port import load_reference_checkpoint as j_load_reference
from ibl_nerf_tpu_torch.cli import port_checkpoint, preprocess
from ibl_nerf_tpu_torch.cli import render as render_cli
from ibl_nerf_tpu_torch.eval import batch_metrics, mse, psnr, ssim
from ibl_nerf_tpu_torch.models.field import FieldConfig
from ibl_nerf_tpu_torch.ops.geometry import pose_spherical
from ibl_nerf_tpu_torch.train import checkpoint as ckpt_lib
from ibl_nerf_tpu_torch.train.step import _leaves, _unflatten, build_optimizer, init_train_state
from ibl_nerf_tpu_torch.utils import mesh_extract
from ibl_nerf_tpu_torch.utils.port import field_params_from_numpy, load_reference_checkpoint
from ibl_nerf_tpu_torch.utils.png import write_png
from ibl_nerf_tpu_torch.utils import video
from ibl_nerf_tpu_torch.utils.video import export_as_video, export_stack_as_video, write_avi

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_scene import make_scene  # noqa: E402

torch.set_num_threads(2)

METRIC_TOL = 5e-5


def _images(seed=0, h=32, w=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 5)], -1)
    return {
        "textured": (a, np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1)),
        # flat patches: the variance terms cancel, the clamps decide
        "flat": (np.full((h, w, 3), 0.6), 0.6 + 1e-3 * rng.standard_normal((h, w, 3))),
        "gray": (a[..., 0], np.clip(a[..., 0] + 0.05 * rng.standard_normal((h, w)), 0, 1)),
    }


@pytest.mark.parametrize("case", ["textured", "flat", "gray"])
def test_metrics_match_jax(case):
    a, b = (np.asarray(x, np.float32) for x in _images()[case])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for fn, jfn in ((mse, j_metrics.mse), (psnr, j_metrics.psnr), (ssim, j_metrics.ssim)):
        out, ref = float(fn(ta, tb)), float(jfn(ja, jb))
        assert abs(out - ref) <= METRIC_TOL * max(1.0, abs(ref)), (fn.__name__, out, ref)
    assert float(ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)
    f64 = float(ssim(ta.double(), tb.double()))
    assert abs(float(ssim(ta, tb)) - f64) <= 2e-6, (float(ssim(ta, tb)), f64)


def test_batch_metrics_match_jax():
    """A stack with values outside [0, 1]: both clip before measuring."""
    rng = np.random.default_rng(1)
    preds = rng.uniform(-0.2, 1.2, (3, 24, 30, 3)).astype(np.float32)
    gts = np.clip(preds + 0.05 * rng.standard_normal(preds.shape), -0.1, 1.1).astype(np.float32)
    out = batch_metrics(preds, gts, device="cpu")
    ref = j_metrics.batch_metrics(preds, gts)
    assert set(out) == set(ref) and set(out["per_image"]) == set(ref["per_image"])
    for k in ("ssim", "psnr", "mse"):
        np.testing.assert_allclose(out[k], ref[k], rtol=METRIC_TOL, atol=METRIC_TOL)
        np.testing.assert_allclose(out["per_image"][k], ref["per_image"][k],
                                   rtol=METRIC_TOL, atol=METRIC_TOL)


def _read_avi(path):
    cap = cv2.VideoCapture(path)
    fps, frames = cap.get(cv2.CAP_PROP_FPS), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return fps, np.stack(frames)


@pytest.mark.parametrize("h,w", [(7, 13), (24, 32)])
def test_stack_video_decodes_to_the_truncated_stack(tmp_path, h, w):
    """Odd widths pad each row; values outside [0, 1] clip; the uint8
    cast truncates, as the JAX package's export does."""
    stack = np.random.default_rng(2).uniform(-0.1, 1.1, (5, h, w, 3)).astype(np.float32)
    path = export_stack_as_video(stack, str(tmp_path / "v.avi"))
    fps, frames = _read_avi(path)
    want = (np.clip(stack, 0, 1) * 255).astype(np.uint8)
    assert fps == 30.0 and frames.shape == (5, h, w, 3)
    np.testing.assert_array_equal(frames[..., ::-1], want)
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    assert data.count(b"00db") == 2 * 5  # a chunk and an index entry per frame


def test_png_sequence_video(tmp_path):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (4, 9, 11, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        write_png(str(tmp_path / f"rgb_{i:03d}.png"), f)
    write_png(str(tmp_path / "albedo_000.png"), frames[0])
    path = export_as_video(str(tmp_path), "rgb_*.png", str(tmp_path / "rgb.avi"))
    _, got = _read_avi(path)
    np.testing.assert_array_equal(got[..., ::-1], frames)
    with pytest.raises(FileNotFoundError, match="no frames"):
        export_as_video(str(tmp_path), "none_*.png", str(tmp_path / "x.avi"))


def test_video_refusals_name_the_reason(tmp_path, monkeypatch):
    """.mp4 and AVIs past 1 GiB are written now (tests/test_torch_video.py);
    what is left to refuse is a file type, frames that are not uint8
    RGB, and a frame larger than one RIFF may hold."""
    frames = np.zeros((2, 4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match=r"\.avi, \.mp4"):
        export_stack_as_video(frames, str(tmp_path / "v.mkv"))
    with pytest.raises(ValueError, match="uint8"):
        write_avi(str(tmp_path / "f.avi"), frames.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        write_avi(str(tmp_path / "g.avi"), frames[..., :2])
    monkeypatch.setattr(video, "AVI_LIMIT", 40)
    with pytest.raises(ValueError, match="does not fit"):
        write_avi(str(tmp_path / "big.avi"), frames)
    assert not os.listdir(tmp_path)


def _sphere_grid(n=24):
    t = np.linspace(-1.5, 1.5, n, dtype=np.float32)
    x, y, z = np.meshgrid(t, t, t, indexing="ij")
    return (100.0 * (1.0 - np.sqrt(x ** 2 + 1.3 * y ** 2 + z ** 2))).astype(np.float32)


def test_marching_cubes_and_tetrahedra_match_jax():
    assert np.array_equal(mesh_extract._MC_TRI_TABLE, j_mesh._MC_TRI_TABLE)
    grid = _sphere_grid()
    for name in ("marching_cubes", "marching_tetrahedra"):
        v, f = getattr(mesh_extract, name)(grid, 50.0)
        jv, jf = getattr(j_mesh, name)(grid, 50.0)
        assert v.shape[0] > 100
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)


def test_density_grid_and_extract_mesh_match_jax(tmp_path):
    jcfg, tcfg = JFieldConfig(depth=4, width=32), FieldConfig(depth=4, width=32)
    jp = j_init(jax.random.key(4), jcfg)
    tp = field_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ref = j_mesh.query_density_grid(jp, jcfg, n=16, radius=1.2, chunk=1000)
    out = mesh_extract.query_density_grid(tp, tcfg, n=16, radius=1.2, chunk=1000)
    assert out.shape == (16, 16, 16) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    iso = float(np.median(ref))
    mesh_extract.extract_mesh(tp, tcfg, str(tmp_path / "port.obj"), n=16, radius=1.2, iso=iso)
    j_mesh.extract_mesh(jp, jcfg, str(tmp_path / "jax.obj"), n=16, radius=1.2, iso=iso)

    def parse(path):
        lines = open(path).read().splitlines()
        v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines if ln[0] == "v"])
        f = np.array([[int(x) for x in ln.split()[1:]] for ln in lines if ln[0] == "f"])
        return v, f

    (v, f), (jv, jf) = parse(tmp_path / "port.obj"), parse(tmp_path / "jax.obj")
    assert len(v) > 50
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=1e-4)


def test_poses_and_trajectories_match_jax():
    for theta, phi, radius in ((0.0, -30.0, 4.0), (123.4, 17.0, 2.5), (-180.0, 90.0, 1.0)):
        np.testing.assert_array_equal(pose_spherical(theta, phi, radius),
                                      j_pose_spherical(theta, phi, radius))
    assert set(render_cli.TRAJECTORIES) == set(j_render_cli.TRAJECTORIES)
    for name, fn in render_cli.TRAJECTORIES.items():
        out = fn(7, -20.0, 3.0)
        assert out.shape == (7, 4, 4) and out.dtype == np.float32
        np.testing.assert_array_equal(out, j_render_cli.TRAJECTORIES[name](7, -20.0, 3.0))


def test_preprocess_writes_the_json_jax_writes(tmp_path):
    make_scene(str(tmp_path / "port"))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    # a second prior level, so the mean is not one image's
    write_png(str(tmp_path / "port" / "train" / "1_ting_s.png"),
              np.random.default_rng(6).integers(0, 256, (40, 52, 3), dtype=np.uint8))
    shutil.copy(tmp_path / "port" / "train" / "1_ting_s.png",
                tmp_path / "jax" / "train" / "1_ting_s.png")
    for side, main in (("port", preprocess.main), ("jax", j_preprocess.main)):
        for name in ("min_max_depth.json", "avg_irradiance.json"):
            os.remove(tmp_path / side / name)
        main(["--datadir", str(tmp_path / side)])
    for name in ("min_max_depth.json", "avg_irradiance.json"):
        assert (open(tmp_path / "port" / name).read()
                == open(tmp_path / "jax" / name).read()), name
    assert set(json.load(open(tmp_path / "port" / "avg_irradiance.json"))) == {
        "mean_bell", "mean_ting"}


def _reference_tar(path, depth=4, k=2, seed=5):
    """A reference-layout checkpoint: Linear weights (out, in)."""
    cfg = JFieldConfig(depth=depth, width=32, coarse_radiance_number=k)

    def state_dict(key):
        p = jax.tree.map(np.asarray, j_init(key, cfg))
        names = {"sigma": "sigma_linear", "albedo_feat": "albedo_feature_linear",
                 "albedo": "albedo_linear", "roughness": "roughness_linear",
                 "irradiance_feat": "irradiance_feature_linear",
                 "irradiance": "irradiance_linear", "feature": "feature_linear",
                 "radiance": "radiance_linear"}
        lin = {f"positions_linears.{i}": p["trunk"][i] for i in range(depth)}
        lin.update({v: p[k_] for k_, v in names.items()})
        lin["views_linears.0"] = p["views"][0]
        for i in range(k):
            lin[f"additional_radiance_feature_linear.{i}"] = p["coarse_feat"][i]
            lin[f"additional_radiance_linear.{i}"] = p["coarse"][i]
        sd = {}
        for name, q in lin.items():
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(q["w"].T))
            sd[f"{name}.bias"] = torch.from_numpy(np.array(q["b"]))
        return sd

    k1, k2 = jax.random.split(jax.random.key(seed))
    torch.save({"network_fn_state_dict": state_dict(k1),
                "network_fine_state_dict": state_dict(k2),
                "global_step": 1234, "elapsed_time": 56.5}, path)


def test_port_checkpoint_matches_the_jax_loader(tmp_path):
    tar = str(tmp_path / "ref.tar")
    _reference_tar(tar)
    coarse, fine, step, elapsed = load_reference_checkpoint(tar, 2, 4, device="cpu")
    jc, jf, jstep, jelapsed = j_load_reference(tar, 2, 4)
    assert (step, elapsed) == (jstep, jelapsed) == (1234, 56.5)

    def same(ours, theirs):
        if isinstance(theirs, dict):
            assert set(ours) == set(theirs)
            for k in theirs:
                same(ours[k], theirs[k])
        elif isinstance(theirs, list):
            assert len(ours) == len(theirs)
            for a, b in zip(ours, theirs):
                same(a, b)
        else:
            np.testing.assert_array_equal(ours.detach().numpy(), np.asarray(theirs))

    same(coarse, jc)
    same(fine, jf)

    path = port_checkpoint.main(["--tar", tar, "--out", str(tmp_path / "out"),
                                 "--coarse_radiance_number", "2", "--netdepth", "4"],
                                device="cpu")
    assert os.path.basename(path) == "ckpt_001234"
    ported = {"coarse": coarse, "fine": fine}
    fresh = _unflatten(ported, [torch.zeros_like(p) for p in _leaves(ported)])
    state = init_train_state(fresh, build_optimizer(fresh))
    state, elapsed, found = ckpt_lib.restore_checkpoint(str(tmp_path / "out"), state)
    assert found and state.step == 1234 and elapsed == 56.5
    same(state.variables, {"coarse": jc, "fine": jf})
