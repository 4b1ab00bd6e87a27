"""Dataset preprocessing: the depth range and the irradiance-prior mean.

    python -m ibl_nerf_tpu_torch.cli.preprocess --datadir <scene> [--prior_type bell ting]

Counterpart of `python -m ibl_nerf_tpu.cli.preprocess`: writes
`min_max_depth.json` (read under --load_depth_range_from_file) and
`avg_irradiance.json` (the prior's mean) into the scene directory. The
prior PNGs decode through the native decoder; their mean over every
channel does not depend on the channel order.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ibl_nerf_tpu_torch.data import native_loader


def compute_min_max_depth(datadir: str, split: str = "train") -> dict:
    depths = sorted(glob.glob(os.path.join(datadir, split, "*_depth.npy")))
    depths = [d for d in depths
              if "edit" not in os.path.basename(d)
              and "insert" not in os.path.basename(d)]
    if not depths:
        raise FileNotFoundError(f"no *_depth.npy under {datadir}/{split}")
    mn, mx = np.inf, -np.inf
    for p in depths:
        d = np.load(p)
        valid = d[d > 0]
        if valid.size:
            mn = min(mn, float(valid.min()))
            mx = max(mx, float(d.max()))
    return {"min_depth": mn, "max_depth": mx}


def compute_avg_irradiance(datadir: str, prior_types=("bell", "ting"),
                           split: str = "train") -> dict:
    out = {}
    for pt in prior_types:
        files = sorted(glob.glob(os.path.join(datadir, split, f"*_{pt}_s.png")))
        if not files:
            continue
        acc = 0.0
        for p in files:
            h, w, _ = native_loader.probe_png(p)
            img = np.rint(native_loader.batch_load_png_rgb([p], h, w)[0] * 255.0)
            acc += float(img.astype(np.float64).mean() / 255.0)
        out[f"mean_{pt}"] = acc / len(files)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("preprocess")
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--prior_type", nargs="*", default=["bell", "ting"])
    args = ap.parse_args(argv)

    mm = compute_min_max_depth(args.datadir, args.split)
    with open(os.path.join(args.datadir, "min_max_depth.json"), "w") as f:
        json.dump(mm, f, indent=2)
    print("min_max_depth.json:", mm)

    avg = compute_avg_irradiance(args.datadir, args.prior_type, args.split)
    if avg:
        with open(os.path.join(args.datadir, "avg_irradiance.json"), "w") as f:
            json.dump(avg, f, indent=2)
        print("avg_irradiance.json:", avg)


if __name__ == "__main__":
    main()
