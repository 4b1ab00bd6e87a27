"""The port's last modules against the JAX package's, on the CPU at
16x16 images: the color helpers, the label encoders, the timing
utilities, `native_available`, the benchmark sweep (CSV text, LaTeX
rows, metrics), the figure tools (kernel curves, crop_zoom, PDFs parsed
back to their pages and images, PNG figures), and the warning
`--use_pallas_train` logs when the K2/K3 gate refuses a phase.
"""

import logging
import os
import re
import signal
import sys
import time
import zlib

import cv2
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from ibl_nerf_tpu.eval import compare as j_compare
from ibl_nerf_tpu.eval import visualize as j_vis
from ibl_nerf_tpu.ops import color as j_color
from ibl_nerf_tpu.utils import labels as j_labels
from ibl_nerf_tpu_torch import ops
from ibl_nerf_tpu_torch.cli.config import parse_with_includes
from ibl_nerf_tpu_torch.data import native_loader
from ibl_nerf_tpu_torch.eval import compare, visualize
from ibl_nerf_tpu_torch.ops import color
from ibl_nerf_tpu_torch.train import loop
from ibl_nerf_tpu_torch.utils import labels, timing
from ibl_nerf_tpu_torch.utils.logging import load_logger
from ibl_nerf_tpu_torch.utils.pdf import Document
from ibl_nerf_tpu_torch.utils.png import write_png

sys.path.insert(0, os.path.dirname(__file__))
from make_synthetic_scene import make_scene  # noqa: E402
from test_visualize import TARGETS, result_tree  # noqa: E402,F401

torch.set_num_threads(2)

METRIC_TOL = 1e-6


# ---------------------------------------------------------------------------
# color helpers
# ---------------------------------------------------------------------------

def test_color_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.2, 1.2, (64, 3))
    for name in ("linear_to_srgb_np", "srgb_to_linear_np"):
        for a in (x, x.astype(np.float32)):
            out, ref = getattr(color, name)(a), getattr(j_color, name)(a)
            assert out.dtype == ref.dtype
            np.testing.assert_array_equal(out, ref)
    a = rng.normal(size=(32, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (32, 3)).astype(np.float32)
    np.testing.assert_array_equal(color.hdr_radiance_activation(torch.from_numpy(a)).numpy(),
                                  np.asarray(j_color.hdr_radiance_activation(a)))
    mse = color.img2mse(torch.from_numpy(a), torch.from_numpy(b))
    j_mse = j_color.img2mse(a, b)
    np.testing.assert_allclose(float(mse), float(j_mse), rtol=1e-6)
    np.testing.assert_allclose(float(color.mse2psnr(mse)), float(j_color.mse2psnr(j_mse)),
                               rtol=1e-6)
    for name in ("img2mse", "mse2psnr", "linear_to_srgb_np", "srgb_to_linear_np"):
        assert getattr(ops, name) is getattr(color, name)


# ---------------------------------------------------------------------------
# label encoders
# ---------------------------------------------------------------------------

COLORS = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0]],
                  np.uint8)


@pytest.mark.parametrize("name", ["OneHotLabelEncoder", "ScalarLabelEncoder",
                                  "ColoredLabelEncoder", "RandomLabelEncoder"])
def test_label_encoders_match_jax(name):
    rng = np.random.default_rng(1)
    label = rng.integers(0, len(COLORS), (16, 16)).astype(np.int32)
    if name == "RandomLabelEncoder":
        ref = j_labels.RandomLabelEncoder(COLORS, dim=8, seed=3)
        enc = labels.RandomLabelEncoder(COLORS, dim=8, device="cpu", codes=np.asarray(ref.codes))
        drawn = jax.random.normal(jax.random.key(3), (len(COLORS), 8))
        np.testing.assert_allclose(ref.codes, drawn / np.linalg.norm(drawn, axis=-1)[:, None],
                                   rtol=1e-6)
        own = labels.RandomLabelEncoder(COLORS, dim=8, seed=3, device="cpu")
        gen = torch.Generator().manual_seed(3)
        raw = torch.randn((len(COLORS), 8), generator=gen)
        torch.testing.assert_close(own.codes, raw / raw.norm(dim=-1, keepdim=True))
        with pytest.raises(ValueError, match="codes"):
            labels.RandomLabelEncoder(COLORS, dim=4, device="cpu", codes=np.asarray(drawn))
    else:
        ref = getattr(j_labels, name)(COLORS)
        enc = getattr(labels, name)(COLORS, device="cpu")
    assert enc.get_dimension() == ref.get_dimension()
    t_label = torch.from_numpy(label)
    encoded = enc.encode(t_label)
    j_encoded = np.asarray(ref.encode(label))
    np.testing.assert_array_equal(encoded.numpy(), j_encoded)
    noisy = j_encoded + rng.normal(0, 0.02, j_encoded.shape).astype(np.float32)
    decoded = enc.decode(torch.from_numpy(noisy))
    np.testing.assert_array_equal(decoded.numpy(), np.asarray(ref.decode(noisy)))
    np.testing.assert_array_equal(decoded.numpy(), label)
    np.testing.assert_array_equal(
        enc.encoded_label_to_colored_label(torch.from_numpy(noisy)).numpy(),
        np.asarray(ref.encoded_label_to_colored_label(noisy)))
    np.testing.assert_allclose(float(enc.error(torch.from_numpy(noisy), t_label)),
                               float(ref.error(noisy, label)), rtol=1e-6)


@pytest.mark.parametrize("name", ["OneHotLabelEncoder", "RandomLabelEncoder"])
def test_label_encoders_default_to_the_card(name):
    """An encoder built without a device is on CUDA, as every entry point
    of the port is; with no card it raises instead of taking the CPU."""
    if torch.cuda.is_available():
        assert getattr(labels, name)(COLORS).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            getattr(labels, name)(COLORS)


def test_label_maps_match_jax():
    rng = np.random.default_rng(2)
    mask = COLORS[rng.integers(0, len(COLORS), (16, 16))]
    mask[0, 0] = (7, 7, 7)  # no color: label 0
    out = labels.colored_mask_to_label_map(mask, COLORS)
    ref = j_labels.colored_mask_to_label_map(mask, COLORS)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        labels.label_to_colored_label(torch.from_numpy(out), torch.from_numpy(COLORS)).numpy(),
        np.asarray(j_labels.label_to_colored_label(out, COLORS)))


# ---------------------------------------------------------------------------
# timeout, profile_trace, native_available
# ---------------------------------------------------------------------------

class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _capture(name):
    handler = _Records()
    load_logger(name).addHandler(handler)
    return handler


def test_timeout_raises_and_restores_the_handler():
    before = signal.getsignal(signal.SIGALRM)

    @timing.timeout(1)
    def slow():
        time.sleep(5)

    @timing.timeout(5)
    def fast():
        return 7

    with pytest.raises(TimeoutError, match="slow timed out after 1s"):
        slow()
    assert fast() == 7
    assert signal.getsignal(signal.SIGALRM) is before


def test_profile_trace_writes_a_trace(tmp_path):
    with timing.profile_trace(str(tmp_path / "prof"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    text = (tmp_path / "prof" / timing.TRACE_NAME).read_text()
    assert '"traceEvents"' in text and "aten::mm" in text
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with timing.profile_trace(str(tmp_path / "cuda")):
                pass


def test_native_available():
    assert native_loader.native_available() is True


# ---------------------------------------------------------------------------
# compare: the benchmark sweep
# ---------------------------------------------------------------------------

@pytest.fixture
def sweep(result_tree, tmp_path):
    """test_visualize's tree as a sweep: results {base}/{scene}/{exp},
    ground truth {data}/{scene}/test; sceneB's gt for image 2 at 20x24,
    so it is resized to the prediction's 16x16."""
    base, gt = result_tree
    data = tmp_path / "data"
    for scene in ("sceneA", "sceneB"):
        d = data / scene / "test"
        d.mkdir(parents=True)
        for f in os.listdir(gt):
            os.symlink(os.path.join(gt, f), d / f)
    big = np.random.default_rng(9).integers(0, 256, (20, 24, 3), dtype=np.uint8)
    os.remove(data / "sceneB" / "test" / "3.png")
    cv2.imwrite(str(data / "sceneB" / "test" / "3.png"), big)
    return base, str(data)


EXPERIMENTS = ["ours/testset_099999", "ours_gt_normal/testset_120000", "missing"]


def test_calculate_metrics_matches_jax(sweep):
    base, data = sweep
    for scene, target in (("sceneA", "image"), ("sceneB", "image"), ("sceneB", "albedo")):
        rdir = os.path.join(base, scene, "ours", "testset_099999")
        gdir = os.path.join(data, scene, "test")
        out = compare.calculate_metrics(rdir, gdir, 3, target, device="cpu")
        ref = j_compare.calculate_metrics(rdir, gdir, 3, target)
        assert set(out) == set(ref) == {"ssim", "psnr", "mse"}
        for k in out:
            np.testing.assert_allclose(out[k], ref[k], rtol=METRIC_TOL, atol=METRIC_TOL)
    empty = compare.calculate_metrics(base, data, 3, device="cpu")
    assert all(np.isnan(v) for v in empty.values())


def test_sweep_csv_and_latex_match_jax(sweep, tmp_path):
    base, data = sweep
    kw = dict(targets=("image", "albedo", "roughness"), n_images=3)
    rows = compare.error_calculator(["sceneA", "sceneB"], EXPERIMENTS, base, data,
                                    out_csv=str(tmp_path / "port.csv"), device="cpu", **kw)
    df = j_compare.error_calculator(["sceneA", "sceneB"], EXPERIMENTS, base, data,
                                    out_csv=str(tmp_path / "jax.csv"), **kw)
    assert len(rows) == len(df) == 18
    # the metrics differ from JAX's in their last bits: score JAX's CSV
    # writer and pivot on the port's own rows
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "pandas.csv").read_text()
    for r, (_, j) in zip(rows, df.iterrows()):
        assert (r["scene"], r["experiment"], r["target"]) == (
            j["scene"], j["experiment"], j["target"])
        for k in ("ssim", "psnr", "mse"):
            np.testing.assert_allclose(r[k], j[k], rtol=METRIC_TOL, atol=METRIC_TOL)
    # JAX's own rows through the port's writer give JAX's CSV text
    compare.write_csv(df.to_dict("records"), str(tmp_path / "jax_rows.csv"))
    assert (tmp_path / "jax_rows.csv").read_text() == (tmp_path / "jax.csv").read_text()
    for metric, fmt in (("psnr", "%.3f"), ("ssim", "%.4f"), ("mse", "%.2e")):
        latex = compare.pprint_latex(rows, metric, fmt)
        assert latex == j_compare.pprint_latex(pd.DataFrame(rows), metric, fmt)
        assert latex == j_compare.pprint_latex(df, metric, fmt)
    assert compare.pprint_latex(rows).splitlines()[0].startswith("ours/testset_099999 & ")
    # duplicates are averaged, NaN rows left out
    dup = rows + [{**rows[0], "psnr": rows[0]["psnr"] + 1.0}]
    assert compare.pprint_latex(dup) == j_compare.pprint_latex(pd.DataFrame(dup))
    assert compare.TARGET_PREFIX == j_compare.TARGET_PREFIX
    assert compare.GT_SUFFIX == j_compare.GT_SUFFIX


def test_time_calculator_csv_matches_jax(tmp_path):
    import json

    logdirs = []
    for i, info in enumerate(({"training_time": 12, "global_step": 3},
                              {"training_time": 1234.5678, "global_step": 120001},
                              {"global_step": 0}, None)):
        d = tmp_path / f"run{i}"
        d.mkdir()
        if info is not None:
            (d / "train_info_step_time.json").write_text(json.dumps(info))
        logdirs.append(str(d))
    rows = compare.time_calculator(logdirs, str(tmp_path / "port.csv"))
    df = j_compare.time_calculator(logdirs, str(tmp_path / "jax.csv"))
    assert len(rows) == len(df) == 3
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    assert compare.time_calculator([], str(tmp_path / "none.csv")) == []
    j_compare.time_calculator([], str(tmp_path / "jnone.csv"))
    assert (tmp_path / "none.csv").read_text() == (tmp_path / "jnone.csv").read_text()


# ---------------------------------------------------------------------------
# visualize: kernel curves, crops, PDFs and PNG figures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,roughness", [(21, 0.2), (21, 0.9), (15, 0.05), (33, 0.5)])
def test_kernel_curves_match_jax(n, roughness):
    for out, ref in zip(visualize.ggx_screen_kernel(n=n, roughness=roughness),
                        j_vis.ggx_screen_kernel(n=n, roughness=roughness)):
        np.testing.assert_array_equal(out, ref)
    kw = dict(length=n, size=1.0 / (0.01 * n), sigma=roughness ** 2)
    for out, ref in zip(visualize.gaussian_kernel_1d(**kw), j_vis.gaussian_kernel_1d(**kw)):
        np.testing.assert_array_equal(out, ref)
    assert visualize.DEFAULT_COMPARE_TARGETS == j_vis.DEFAULT_COMPARE_TARGETS


@pytest.mark.parametrize("box,scale", [((2, 3, 7, 5), 4), ((0, 0, 16, 16), 3), ((9, 1, 6, 13), 1)])
def test_crop_zoom_matches_cv2(tmp_path, box, scale):
    img = np.random.default_rng(4).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    src = str(tmp_path / "src.png")
    cv2.imwrite(src, img)
    visualize.crop_zoom(src, box, str(tmp_path / "port.png"), scale)
    j_vis.crop_zoom(src, box, str(tmp_path / "jax.png"), scale)
    out, ref = cv2.imread(str(tmp_path / "port.png")), cv2.imread(str(tmp_path / "jax.png"))
    assert out.shape == (box[3] * scale, box[2] * scale, 3)
    np.testing.assert_array_equal(out, ref)


def _pdf(path):
    """(page count, [(h, w, 3) uint8 image of each XObject in file order])."""
    data = open(path, "rb").read()
    assert data.startswith(b"%PDF-1.4") and data.rstrip().endswith(b"%%EOF")
    pages = int(re.search(rb"/Type /Pages /Kids \[[^\]]*\] /Count (\d+)", data).group(1))
    assert len(re.findall(rb"/Type /Page /Parent", data)) == pages
    images = []
    for m in re.finditer(rb"/Subtype /Image /Width (\d+) /Height (\d+) .*?/Length (\d+) "
                         rb">>\nstream\n", data):
        w, h, n = (int(g) for g in m.groups())
        raw = zlib.decompress(data[m.end():m.end() + n])
        images.append(np.frombuffer(raw, np.uint8).reshape(h, w, 3))
    # the cross-reference table points at every object
    xref = int(data.rsplit(b"startxref\n", 1)[1].split()[0])
    entries = data[xref:].split(b"\n")[3:]
    for i, line in enumerate(entries):
        if not line.endswith(b" n "):
            break
        assert data[int(line[:10]):].startswith(f"{i + 1} 0 obj".encode())
    return pages, images


def _png(path):
    return cv2.imread(path)[..., ::-1] if os.path.exists(path) else None


def _expected_tiles(base, gt, scene, exps, targets, index, iters):
    tiles = []
    for t in targets:
        suffix = "" if t == "rgb" else f"_{t}"
        tiles.append(_png(os.path.join(gt, f"{index + 1}{suffix}.png")))
    tiles = [tiles]
    for exp in exps:
        d = os.path.join(base, scene, exp, f"testset_{iters[exp]:06d}")
        tiles.append([_png(os.path.join(d, f"{t}_{index:03d}.png")) for t in targets])
    return [img for row in tiles for img in row if img is not None]


ITERS = {"ours": 99999, "ours_gt_normal": 120000}


def test_visualize_comparison_pdf_holds_the_pngs(result_tree, tmp_path):
    base, gt = result_tree
    # drop one tile: its cell stays empty
    os.remove(os.path.join(base, "sceneA", "ours", "testset_099999", "albedo_001.png"))
    pdf = visualize.visualize_comparison(base, "sceneA", index=1, compare_targets=list(TARGETS),
                                         gt_dir=gt, out_dir=str(tmp_path / "figs"))
    ref = j_vis.visualize_comparison(base, "sceneA", index=1, compare_targets=list(TARGETS),
                                     gt_dir=gt, out_dir=str(tmp_path / "jax"))
    assert os.path.basename(pdf) == os.path.basename(ref) == "sceneA.pdf"
    pages, images = _pdf(pdf)
    want = _expected_tiles(base, gt, "sceneA", ["ours", "ours_gt_normal"], TARGETS, 1, ITERS)
    assert pages == 1 and len(images) == len(want) == 8
    for got, exp in zip(images, want):
        np.testing.assert_array_equal(got, exp)
    data = open(pdf, "rb").read()
    assert b"(Scene: sceneA, Index: 1) Tj" in zlib.decompress(_content(data))


def _content(data):
    m = re.search(rb"<< /Filter /FlateDecode /Length (\d+) >>\nstream\n", data)
    return data[m.end():m.end() + int(m.group(1))]


def test_visualize_comparison_picks_the_newest_testset(result_tree, tmp_path):
    base, _ = result_tree
    d = os.path.join(base, "sceneA", "ours_gt_normal")
    os.makedirs(os.path.join(d, "testset_99999"))  # newest by name, not by number
    pdf = visualize.visualize_comparison(base, "sceneA", index=0, exp_names=["ours_gt_normal"],
                                         compare_targets=["rgb"], out_dir=str(tmp_path))
    _, images = _pdf(pdf)
    np.testing.assert_array_equal(images[0], _png(os.path.join(d, "testset_120000",
                                                                "rgb_000.png")))
    # exp_names from the scene directory, natural order; target_iter picks one
    pdf = visualize.visualize_comparison(base, "sceneA", index=0, compare_targets=["rgb"],
                                         target_iter=99999, out_dir=str(tmp_path))
    _, images = _pdf(pdf)
    assert len(images) == 1  # ours_gt_normal has no testset_099999
    assert visualize._natsorted(["e10", "e9", "a"]) == j_vis._natsorted(["e10", "e9", "a"])


def test_comparison_report_one_page_per_scene(result_tree, tmp_path):
    base, gt = result_tree
    out = visualize.comparison_report(base, ["sceneA", "sceneB"], str(tmp_path / "r" / "m.pdf"),
                                      index=2, compare_targets=list(TARGETS), gt_dir=gt)
    pages, images = _pdf(out)
    assert pages == 2 and b"/Count 2" in open(out, "rb").read()
    want = sum((_expected_tiles(base, gt, s, ["ours", "ours_gt_normal"], TARGETS, 2, ITERS)
                for s in ("sceneA", "sceneB")), [])
    assert len(images) == len(want) == 18
    for got, exp in zip(images, want):
        np.testing.assert_array_equal(got, exp)


def test_comparison_grid_pdf_and_png(result_tree, tmp_path):
    base, gt = result_tree
    dirs = {"ours": os.path.join(base, "sceneA", "ours", "testset_099999"),
            "gtn": os.path.join(base, "sceneA", "ours_gt_normal", "testset_120000")}
    pdf = visualize.comparison_grid(dirs, ["rgb", "albedo"], 1, str(tmp_path / "g.pdf"), gt)
    _, images = _pdf(pdf)
    want = [_png(os.path.join(gt, "2.png"))] + [
        _png(os.path.join(d, f"{b}_001.png")) for d in dirs.values() for b in ("rgb", "albedo")]
    assert len(images) == 5
    for got, exp in zip(images, want):
        np.testing.assert_array_equal(got, exp)
    png = visualize.comparison_grid(dirs, ["rgb", "albedo"], 1, str(tmp_path / "g.png"))
    img = _png(png)
    assert img.shape == (round((0.4 + 2 * 3) * 100), round((0.4 + 2 * 3) * 100), 3)
    # the tile of (ours, rgb), upscaled by nearest neighbour, is in the PNG
    # (cells of 3 inches at 100 dpi from 0.4 inches, a tile 92% of its cell)
    tile = want[1]
    np.testing.assert_array_equal(img[60, 60], tile[0, 0])
    np.testing.assert_array_equal(img[320, 320], tile[15, 15])
    with pytest.raises(ValueError, match="pdf or .png"):
        visualize.comparison_grid(dirs, ["rgb"], 1, str(tmp_path / "g.jpg"))


def test_prefiltered_strip_and_kernel_figure(tmp_path):
    rng = np.random.default_rng(5)
    levels = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(3)]
    write_png(str(tmp_path / "radiance_004.png"), levels[0])
    write_png(str(tmp_path / "radiance_1_004.png"), levels[1])
    write_png(str(tmp_path / "radiance_3_004.png"), levels[2])
    out = visualize.prefiltered_strip(str(tmp_path), 4, 3, str(tmp_path / "strip.png"))
    img = _png(out)
    assert img.shape == (round(3.4 * 100), 900, 3)
    for c, lv in enumerate(levels):  # each cell's centre pixel is its level's
        np.testing.assert_array_equal(img[40 + 150, c * 300 + 150], lv[8, 8])
    for ext in ("pdf", "png"):
        fig = visualize.ggx_gaussian_figure(str(tmp_path / f"ggx.{ext}"))
        assert os.path.getsize(fig) > 1000
    data = open(tmp_path / "ggx.pdf", "rb").read()
    pages, images = _pdf(str(tmp_path / "ggx.pdf"))
    stream = zlib.decompress(_content(data)).decode()
    assert pages == 1 and not images
    assert stream.count(" S Q") == 20 + 1 + 5 + 10  # curves, frame, ticks, legend
    assert "[4 3] 0 d" in stream and "(roughness) Tj" in stream


def test_pdf_text_is_escaped(tmp_path):
    doc = Document()
    page = doc.add_page(100, 50)
    page.text("a(b)\\cé", 10, 20, 8)
    doc.save(str(tmp_path / "t.pdf"))
    data = open(tmp_path / "t.pdf", "rb").read()
    assert b"(a\\(b\\)\\\\c?) Tj" in zlib.decompress(_content(data))
    assert _pdf(str(tmp_path / "t.pdf")) == (1, [])


# ---------------------------------------------------------------------------
# the --use_pallas_train fallback is logged
# ---------------------------------------------------------------------------

def test_pallas_train_fallback_is_logged(tmp_path):
    """Depth 8 with the default skip and bf16_grad: K2/K3 hold the first
    phase; --freeze_radiance freezes the heads from update 3, where the
    gate refuses and the loop says so once."""
    scene = make_scene(str(tmp_path / "scene"), h=16, w=16, n_train=2, n_test=1)
    argv = ["--datadir", scene, "--basedir", str(tmp_path / "logs"), "--expname", "exp",
            "--netdepth", "8", "--netwidth", "16", "--N_rand", "16", "--N_samples", "4",
            "--N_importance", "4", "--N_iter", "4", "--coarse_radiance_number", "2",
            "--load_depth_range_from_file", "--N_iter_ignore_approximated_radiance", "3",
            "--i_weights", "100", "--i_testset", "100", "--summary_step", "2",
            "--use_pallas_train", "--freeze_radiance"]
    handler = _capture("train")
    try:
        loop.train(parse_with_includes(argv), device="cpu")
        warned = [m for m in handler.messages if "--use_pallas_train" in m]
        assert warned == ["--use_pallas_train: from update 3 the gradient path runs the eager "
                          "field query, not K2/K3 (freeze: the radiance heads are frozen in "
                          "this phase)"]
        handler.messages.clear()
        loop.train(parse_with_includes(argv[:-1] + ["--netdepth", "6", "--expname", "exp6"]),
                   device="cpu")
        warned = [m for m in handler.messages if "--use_pallas_train" in m]
        assert len(warned) == 1 and warned[0].endswith("(depth: netdepth 6, K2/K3 hold 8 "
                                                       "layers)")
    finally:
        load_logger("train").removeHandler(handler)
