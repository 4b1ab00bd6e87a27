"""Result-comparison figure tooling.

Counterpart of ibl_nerf_tpu/eval/visualize.py without matplotlib or
cv2: experiment x buffer grids (one PDF per scene, and a merged report
of one page per scene), the GGX-vs-Gaussian screen-kernel figure, zoom
crops and mip strips. Each function writes the files JAX's writes, with
the same names, page counts and tiles in the same grid; PDFs come from
`utils/pdf.py` (each tile embedded at its PNG's own pixels), PNGs are
composed in numpy (`utils/raster.py`) and written by `utils/png.py`.
matplotlib's rasterisation is not reproduced: a figure's layout, fonts
and pixels differ from JAX's. The kernel curves and `crop_zoom`'s
pixels are JAX's bit for bit.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ibl_nerf_tpu_torch.data import native_loader
from ibl_nerf_tpu_torch.utils.pdf import Document, text_width
from ibl_nerf_tpu_torch.utils.png import write_png
from ibl_nerf_tpu_torch.utils.raster import Canvas

INCH = 72.0
# matplotlib's default colour cycle (tab10)
_COLORS = ("1f77b4", "ff7f0e", "2ca02c", "d62728", "9467bd",
           "8c564b", "e377c2", "7f7f7f", "bcbd22", "17becf")


def _imread(path: str) -> np.ndarray | None:
    """(H, W, 3) uint8 RGB of a PNG, None when the file is missing."""
    if not os.path.exists(path):
        return None
    h, w, _ = native_loader.probe_png(path)
    return np.rint(native_loader.batch_load_png_rgb([path], h, w)[0] * 255).astype(np.uint8)


def _fit(img: np.ndarray, x: float, y: float, w: float, h: float):
    """The box of `img` at its aspect ratio, centred in (x, y, w, h)."""
    s = min(w / img.shape[1], h / img.shape[0])
    iw, ih = img.shape[1] * s, img.shape[0] * s
    return x + (w - iw) / 2, y + (h - ih) / 2, iw, ih


def _surface(out_path: str, width: float, height: float):
    """(canvas, save): a PDF page for a .pdf path, else a raster canvas
    saved as PNG."""
    if out_path.lower().endswith(".pdf"):
        doc = Document()
        return doc.add_page(width, height), lambda: doc.save(out_path)
    if not out_path.lower().endswith(".png"):
        raise ValueError(f"{out_path}: figures are written as .pdf or .png")
    canvas = Canvas(width, height)
    return canvas, lambda: write_png(out_path, canvas.pixels)


def _tile_grid(canvas, tiles, n_r: int, n_c: int, left: float, top: float, cell: float,
               frame: bool) -> None:
    """tiles[r][c] (an image or None) into an n_r x n_c grid of square
    cells from (left, top)."""
    pad = 0.04 * cell
    for r in range(n_r):
        for c in range(n_c):
            x, y = left + c * cell + pad, top + r * cell + pad
            box = (x, y, cell - 2 * pad, cell - 2 * pad)
            img = tiles[r][c]
            if img is not None:
                box = _fit(img, *box)
                canvas.image(img, *box)
            if frame:
                canvas.rect(*box)


def comparison_grid(result_dirs: dict[str, str], buffers: list[str],
                    image_idx: int, out_path: str, gt_dir: str | None = None):
    """Rows = experiments (+gt), cols = buffers, for one test image."""
    rows = list(result_dirs.items())
    n_r, n_c = len(rows) + (1 if gt_dir else 0), len(buffers)
    cell, left, top = 3 * INCH, 0.4 * INCH, 0.4 * INCH
    canvas, save = _surface(out_path, left + n_c * cell, top + n_r * cell)
    tiles = []
    if gt_dir:
        gt = _imread(os.path.join(gt_dir, f"{image_idx + 1}.png"))
        tiles.append([gt if buf == "rgb" else None for buf in buffers])
        canvas.text("ground truth", left, top - 6, 12)
    for ri, (name, d) in enumerate(rows):
        tiles.append([_imread(os.path.join(d, f"{buf}_{image_idx:03d}.png"))
                      for buf in buffers])
        canvas.text(name, left - 6, top + (ri + (1 if gt_dir else 0) + 0.5) * cell, 10,
                    "center", vertical=True)
    if not gt_dir:
        for ci, buf in enumerate(buffers):
            canvas.text(buf, left + (ci + 0.5) * cell, top - 6, 12, "center")
    _tile_grid(canvas, tiles, n_r, n_c, left, top, cell, frame=False)
    save()
    return out_path


DEFAULT_COMPARE_TARGETS = ("disp", "albedo", "irradiance", "roughness",
                           "diffuse", "specular", "rgb", "radiance")


def _natsorted(names):
    key = lambda s: [int(t) if t.isdigit() else t  # noqa: E731
                     for t in re.split(r"(\d+)", s)]
    return sorted(names, key=key)


def visualize_comparison(basedir: str, scene_name: str, index: int = 1,
                         exp_names: list[str] | None = None,
                         compare_targets=None, target_iter: int = -1,
                         gt_dir: str | None = None,
                         out_dir: str | None = None,
                         page=None):
    """Experiment x buffer grid for one test image of one scene: rows =
    experiments ('gt' row first when gt_dir is given), cols =
    compare_targets, buffer names over the top row, experiment names
    left of the first column, the title "Scene: ..., Index: ...";
    a missing image leaves an empty cell.

    Images are read from
    `{basedir}/{scene}/{exp}/testset_{iter:06d}/{target}_{idx:03d}.png`
    (target_iter=-1: the newest testset_* dir). Returns the written PDF
    (`{out_dir or basedir}/{scene}.pdf`), or draws onto `page` (a
    `utils/pdf.Page`, as comparison_report passes) and returns None.
    """
    if compare_targets is None:
        compare_targets = list(DEFAULT_COMPARE_TARGETS)
    scene_dir = os.path.join(basedir, scene_name)
    if exp_names is None:
        exp_names = _natsorted(
            [d for d in os.listdir(scene_dir)
             if os.path.isdir(os.path.join(scene_dir, d))])
    rows = (["gt"] if gt_dir else []) + list(exp_names)

    def testset_dir(exp):
        d = os.path.join(scene_dir, exp)
        if target_iter >= 0:
            return os.path.join(d, f"testset_{target_iter:06d}")
        cands = _natsorted([s for s in os.listdir(d)
                            if s.startswith("testset_")]) if os.path.isdir(d) else []
        return os.path.join(d, cands[-1]) if cands else d

    tiles = []
    for exp in rows:
        row = []
        for target in compare_targets:
            if exp == "gt":
                suffix = "" if target == "rgb" else f"_{target}"
                row.append(_imread(os.path.join(gt_dir, f"{index + 1}{suffix}.png")))
            else:
                row.append(_imread(os.path.join(testset_dir(exp), f"{target}_{index:03d}.png")))
        tiles.append(row)

    n_row, n_col = len(rows), len(compare_targets)
    doc = None
    if page is None:
        doc = Document()
        page = doc.add_page((2 * n_col + 2) * INCH, 2 * n_row * INCH)
    left, top, bottom = 0.5 * INCH, 0.8 * INCH, 0.2 * INCH
    cell = min((page.width - left - 0.2 * INCH) / n_col,
               (page.height - top - bottom) / n_row)
    title = f"Scene: {scene_name}, Index: {index}"
    page.text(title, page.width / 2, 0.35 * INCH, 14, "center")
    for c, target in enumerate(compare_targets):
        page.text(target, left + (c + 0.5) * cell, top - 5, 10, "center")
    for r, exp in enumerate(rows):
        page.text(exp, left - 5, top + (r + 0.5) * cell, 10, "center", vertical=True)
    _tile_grid(page, tiles, n_row, n_col, left, top, cell, frame=True)
    if doc is None:
        return None
    out_dir = out_dir or basedir
    os.makedirs(out_dir, exist_ok=True)
    return doc.save(os.path.join(out_dir, f"{scene_name}.pdf"))


def comparison_report(basedir: str, scene_names: list[str], out_pdf: str,
                      index: int = 1, **kw):
    """Multi-scene comparison PDF: one visualize_comparison page (18 x
    12 inches) per scene."""
    os.makedirs(os.path.dirname(out_pdf) or ".", exist_ok=True)
    doc = Document()
    for scene in scene_names:
        visualize_comparison(basedir, scene, index=index,
                             page=doc.add_page(18 * INCH, 12 * INCH), **kw)
    return doc.save(out_pdf)


def ggx_screen_kernel(n: int = 21, roughness: float = 0.2,
                      epsilon: float = 0.01, focal_length: float = 1.0):
    """Screen-space GGX filtering kernel cross-section: pixel offsets
    around a head-on surface point, the half-vector GGX NDF D(h)·(h·n)
    converted to a solid-angle pdf /(4 h·i), then to a pixel-area pdf
    ·(i·n / d²), normalized. Returns (offsets (n,), kernel (n,))."""
    o = np.array([0.0, 0.0, 1.0])
    nrm = np.array([0.0, 0.0, 1.0])
    mid = n // 2
    nx = np.linspace(-1, 1, n) * epsilon * n
    xv, yv = np.meshgrid(nx, nx)
    i = np.stack([xv, yv, np.ones_like(xv) * focal_length], axis=-1)
    dist_sq = np.sum(i * i, axis=-1)
    i = i / np.linalg.norm(i, axis=-1, keepdims=True)
    h = i + o
    h = h / np.linalg.norm(h, axis=-1, keepdims=True)
    h_dot_n = np.sum(h * nrm, axis=-1)
    h_dot_i = np.sum(h * i, axis=-1)
    i_dot_n = np.sum(i * nrm, axis=-1)
    alpha = roughness * roughness
    a2 = alpha * alpha
    t = 1.0 + (a2 - 1.0) * h_dot_n * h_dot_n
    d = a2 / (np.pi * t * t)
    pdf_area = d * h_dot_n / (4.0 * h_dot_i) * (i_dot_n / dist_sq)
    kernel = pdf_area / pdf_area.sum()
    return nx, kernel[mid]


def gaussian_kernel_1d(length: int = 101, size: float = 20.0,
                       sigma: float = 0.2):
    """Normalized 2-D gaussian kernel cross-section."""
    mid = length // 2
    ax = np.linspace(-(length - 1) / 2.0, (length - 1) / 2.0, length) / size
    g = np.exp(-0.5 * np.square(ax) / np.square(sigma))
    k = np.outer(g, g)
    k = k / k.sum()
    return ax, k[mid]


def ggx_gaussian_figure(out_path: str, n: int = 21,
                        roughnesses=tuple((i + 1) * 0.1 for i in range(10)),
                        with_gaussian: bool = True):
    """The GGX-vs-Gaussian screen-kernel comparison figure (6 x 4
    inches, .pdf or .png): one GGX screen-kernel curve per roughness,
    optional matched gaussian overlays (dashed, lighter)."""
    curves = []
    for ci, r in enumerate(roughnesses):
        color = tuple(int(_COLORS[ci % 10][j:j + 2], 16) / 255 for j in (0, 2, 4))
        nx, k = ggx_screen_kernel(n=n, roughness=r)
        curves.append((nx, k, color, False, f"{r:.2f}"))
        if with_gaussian:
            gx, gk = gaussian_kernel_1d(length=n, size=1.0 / (0.01 * n), sigma=r * r)
            light = tuple(0.4 * v + 0.6 for v in color)
            curves.append((gx, gk / gk.sum() * k.sum(), light, True, None))

    width, height = 6 * INCH, 4 * INCH
    canvas, save = _surface(out_path, width, height)
    x0, y0, x1, y1 = 0.5 * INCH, 0.15 * INCH, width - 0.35 * INCH, height - 0.6 * INCH
    lo = min(float(c[0].min()) for c in curves)
    hi = max(float(c[0].max()) for c in curves)
    top = max(float(c[1].max()) for c in curves) * 1.05 or 1.0

    def to_page(x, v):
        return np.stack([x0 + (x - lo) / (hi - lo) * (x1 - x0), y1 - v / top * (y1 - y0)], -1)

    for x, v, color, dashed, _ in curves:
        canvas.polyline(to_page(x, v), color, 1.5, dashed)
    canvas.rect(x0, y0, x1 - x0, y1 - y0)
    for t in np.linspace(lo, hi, 5):
        px = float(to_page(np.array(t), np.array(0.0))[0])
        canvas.polyline([(px, y1), (px, y1 + 4)])
        canvas.text(f"{t:.2f}", px, y1 + 16, 9, "center")
    canvas.text("pixel position", (x0 + x1) / 2, height - 0.15 * INCH, 10, "center")
    labelled = [c for c in curves if c[4] is not None]
    lx = x1 - 8 - max(text_width("roughness", 8), 30 + text_width("0.00", 7))
    canvas.text("roughness", lx, y0 + 14, 8)
    for j, (_, _, color, _, label) in enumerate(labelled):
        ly = y0 + 26 + 10 * j
        canvas.polyline([(lx, ly - 3), (lx + 20, ly - 3)], color, 1.5)
        canvas.text(label, lx + 26, ly, 7)
    save()
    return out_path


def crop_zoom(image_path: str, box: tuple[int, int, int, int],
              out_path: str, scale: int = 4):
    """Crop (x, y, w, h) and upscale by an integer factor, each pixel
    repeated (cv2.INTER_NEAREST at that factor), for figure insets."""
    img = _imread(image_path)
    if img is None:
        raise FileNotFoundError(image_path)
    x, y, w, h = box
    crop = img[y:y + h, x:x + w]
    write_png(out_path, np.repeat(np.repeat(crop, scale, 0), scale, 1))
    return out_path


def prefiltered_strip(result_dir: str, image_idx: int, levels: int,
                      out_path: str):
    """Side-by-side radiance mip levels (one 3-inch cell each, titled)."""
    imgs = []
    base = _imread(os.path.join(result_dir, f"radiance_{image_idx:03d}.png"))
    if base is not None:
        imgs.append(("radiance", base))
    for k in range(1, levels + 1):
        img = _imread(os.path.join(result_dir, f"radiance_{k}_{image_idx:03d}.png"))
        if img is not None:
            imgs.append((f"level {k}", img))
    n = max(len(imgs), 1)
    cell, top = 3 * INCH, 0.4 * INCH
    canvas, save = _surface(out_path, n * cell, top + cell)
    for c, (name, _) in enumerate(imgs):
        canvas.text(name, (c + 0.5) * cell, top - 6, 12, "center")
    _tile_grid(canvas, [[img for _, img in imgs] + [None] * (n - len(imgs))], 1, n, 0.0,
               top, cell, frame=False)
    save()
    return out_path
