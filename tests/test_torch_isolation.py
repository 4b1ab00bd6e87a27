"""The port stands alone: importing every module of ibl_nerf_tpu_torch
and chip_smoke.py loads no jax, no ibl_nerf_tpu, no cv2, no pandas and
no matplotlib (the card's machine has none of the last three); its LUT
asset is the JAX package's LUT; and chip_smoke.py refuses to run without
a card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from ibl_nerf_tpu.data.brdf_lut import load_brdf_lut as j_load_lut
from ibl_nerf_tpu_torch.data.brdf_lut import _DEFAULT_PATH, load_brdf_lut

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ibl_nerf_tpu", "cv2", "pandas", "matplotlib")

_PROBE = """
import importlib, json, pkgutil, sys
import ibl_nerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ibl_nerf_tpu_torch.__path__,
                                               "ibl_nerf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"modules": names,
                  "loaded": sorted({n.split(".")[0] for n in sys.modules})}))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_nothing_of_jax():
    proc = _run(["-c", _PROBE], REPO)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("kernels.fused_field", "kernels.fused_field_train", "eval.render_path",
                 "train.step", "train.losses", "data.sampler", "cli.test", "cli.render",
                 "cli.port_checkpoint", "cli.preprocess", "utils.video",
                 "utils.mesh_extract", "eval.metrics", "parallel", "parallel.mesh",
                 "parallel.distributed", "eval.compare", "eval.visualize", "utils.timing",
                 "utils.labels", "utils.pdf", "utils.raster", "data.native_loader"):
        assert f"ibl_nerf_tpu_torch.{name}" in report["modules"]
    assert not set(report["loaded"]) & set(FORBIDDEN), report["loaded"]


def test_lut_asset_is_the_reference_lut():
    raw = np.load(_DEFAULT_PATH)
    assert raw.dtype == np.uint8 and raw.shape == (512, 512, 3)
    ref = j_load_lut()
    np.testing.assert_array_equal(raw, np.round(ref * 255.0).astype(np.uint8))
    np.testing.assert_array_equal(load_brdf_lut(device="cpu").numpy(), ref)


def test_chip_smoke_fails_without_a_card():
    """No CUDA device: a non-zero exit and no result line."""
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    proc = _run([str(alone)], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
