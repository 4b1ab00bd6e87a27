"""Nothing under benchmark/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ibl_nerf_tpu"}


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    for path in BENCH.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_reference_is_independent():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not imported(path) & (FORBIDDEN | {"ibl_nerf_tpu_torch"}), path


def test_loaded_modules():
    """What a run's drivers and readers load, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, readers, trace, faults, inputs, flops\n"
        "from benchmark.reference import nerf\n"
        "ref = {m.split('.')[0] for m in sys.modules}\n"
        "import benchmark.traffic.train_updates, benchmark.traffic.render_frames\n"
        "import ibl_nerf_tpu_torch.train.loop, ibl_nerf_tpu_torch.eval.render_path\n"
        "for p in sorted(harness.BENCH.glob('metrics/*.py')): harness.load_module(p)\n"
        "print(sorted(ref & {'ibl_nerf_tpu_torch'}), harness.forbidden_modules())\n"
    ) % str(BENCH.parent)
    # a bare environment: no site path that could load a module of its own
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={"PATH": os.environ.get("PATH", "/usr/bin:/bin")})
    assert out.stdout.strip() == "[] []"
