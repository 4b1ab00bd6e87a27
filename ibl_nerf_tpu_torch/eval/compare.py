"""Benchmark sweep tooling: metrics over scenes x experiments x targets.

Counterpart of ibl_nerf_tpu/eval/compare.py without cv2 or pandas:
PNGs decode through the native decoder, a ground truth of another size
is resized as `cv2.resize` does by default (INTER_LINEAR on float32,
`data/resize.py`), and the metrics run on the card unless `device`
names another. A table is a list of row dicts; its CSV text is what
pandas' `DataFrame(rows).to_csv(index=False)` writes (the header from
the first row, a numeric column holding a float written as floats, NaN
as an empty field, minimal quoting, "\\n" line ends).
"""

from __future__ import annotations

import csv
import json
import math
import os

import numpy as np

from ibl_nerf_tpu_torch.data import native_loader
from ibl_nerf_tpu_torch.data.resize import resize
from ibl_nerf_tpu_torch.eval.metrics import batch_metrics

# render-output prefix per evaluation target
TARGET_PREFIX = {
    "image": "rgb",
    "diffuse": "diffuse",
    "specular": "specular",
    "albedo": "albedo",
    "roughness": "roughness",
    "irradiance": "irradiance",
}
GT_SUFFIX = {
    "image": "",
    "diffuse": "_diffuse",
    "specular": "_specular",
    "albedo": "_albedo",
    "roughness": "_roughness",
    "irradiance": "_irradiance",
}


def _load_png01(path: str) -> np.ndarray | None:
    """(H, W, 3) float32 RGB in [0, 1] at the file's size; None when the
    file is missing (cv2.imread's None), as JAX's loader skips it."""
    if not os.path.exists(path):
        return None
    h, w, _ = native_loader.probe_png(path)
    return native_loader.batch_load_png_rgb([path], h, w)[0]


def calculate_metrics(result_dir: str, gt_dir: str, n_images: int,
                      target: str = "image", device=None) -> dict:
    """Mean SSIM/PSNR/MSE of `{prefix}_{i:03d}.png` vs gt
    `{i+1}{suffix}.png`, over the pairs where both files exist."""
    preds, gts = [], []
    prefix = TARGET_PREFIX[target]
    suffix = GT_SUFFIX[target]
    for i in range(n_images):
        p = _load_png01(os.path.join(result_dir, f"{prefix}_{i:03d}.png"))
        g = _load_png01(os.path.join(gt_dir, f"{i + 1}{suffix}.png"))
        if p is None or g is None:
            continue
        if p.shape != g.shape:
            g = resize(g, (p.shape[1], p.shape[0]))
        preds.append(p)
        gts.append(g)
    if not preds:
        return {"ssim": float("nan"), "psnr": float("nan"),
                "mse": float("nan")}
    m = batch_metrics(np.stack(preds), np.stack(gts), device=device)
    return {k: m[k] for k in ("ssim", "psnr", "mse")}


def _is_float(v) -> bool:
    return isinstance(v, (float, np.floating))


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))


def write_csv(rows: list[dict], path: str) -> None:
    """`rows` as pandas' `DataFrame(rows).to_csv(path, index=False)`
    writes them: a column of ints and floats is written as floats."""
    columns = list(dict.fromkeys(k for r in rows for k in r))
    as_float = {c for c in columns
                if any(_is_float(r.get(c)) for r in rows)
                and all(_is_float(r.get(c)) or _is_int(r.get(c)) for r in rows)}

    def cell(c, v):
        if v is None or (_is_float(v) and math.isnan(v)):
            return ""
        if c in as_float:
            return str(v if _is_float(v) else float(v))
        return str(v)

    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for r in rows:
            writer.writerow([cell(c, r.get(c)) for c in columns])


def error_calculator(scenes: list[str], experiments: list[str],
                     results_root: str, data_root: str,
                     targets=("image", "albedo", "roughness", "irradiance"),
                     n_images: int = 100, out_csv: str | None = None,
                     device=None) -> list[dict]:
    """Sweep scenes x experiments x targets into a list of rows
    {scene, experiment, target, ssim, psnr, mse}."""
    rows = []
    for scene in scenes:
        for exp in experiments:
            rdir = os.path.join(results_root, scene, exp)
            gdir = os.path.join(data_root, scene, "test")
            for target in targets:
                m = calculate_metrics(rdir, gdir, n_images, target, device)
                rows.append({"scene": scene, "experiment": exp,
                             "target": target, **m})
    if out_csv:
        write_csv(rows, out_csv)
    return rows


def time_calculator(logdirs: list[str], out_csv: str | None = None) -> list[dict]:
    """time/step rows from each logdir's train_info_step_time.json."""
    rows = []
    for d in logdirs:
        info_path = os.path.join(d, "train_info_step_time.json")
        if not os.path.exists(info_path):
            continue
        with open(info_path) as f:
            info = json.load(f)
        steps = max(info.get("global_step", 1), 1)
        rows.append({
            "logdir": d,
            "training_time": info.get("training_time", float("nan")),
            "global_step": steps,
            "time_per_step": info.get("training_time", float("nan")) / steps,
        })
    if out_csv:
        write_csv(rows, out_csv)
    return rows


def pprint_latex(rows: list[dict], metric: str = "psnr",
                 float_fmt: str = "%.3f") -> str:
    """LaTeX table rows of one metric, experiments (sorted) by scenes
    (sorted), over the rows whose target is "image": JAX's pivot_table
    -- the mean of duplicates, NaN values left out, a pair with no value
    printed as nan."""
    cells: dict[tuple, list] = {}
    for r in rows:
        v = r[metric]
        if r["target"] == "image" and not (_is_float(v) and math.isnan(v)):
            cells.setdefault((r["experiment"], r["scene"]), []).append(v)
    means = {k: sum(v) / len(v) for k, v in cells.items()}
    scenes = sorted({s for _, s in means})
    lines = []
    for exp in sorted({e for e, _ in means}):
        row = " & ".join(float_fmt % means.get((exp, s), float("nan")) for s in scenes)
        lines.append(f"{exp} & {row} \\\\")
    return "\n".join(lines)
