"""The port does all that the JAX package does: every module of
ibl_nerf_tpu/ has a module of the same path in ibl_nerf_tpu_torch/, and
each top-level public function, class and constant there (each name a
package `__init__` exports) has a counterpart of the same name in the
port's module. The exemptions are listed below, each with its reason.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = REPO / "ibl_nerf_tpu", REPO / "ibl_nerf_tpu_torch"

EXEMPT_MODULES = {
    # sets libtpu's scoped-VMEM flag for the Pallas kernels: a TPU
    # runtime setting with no CUDA counterpart
    "utils/tpu.py",
    # XLA's persistent compilation cache; the port's counterpart is the
    # build cache of kernels/build.py under the git-ignored build/
    "utils/cache.py",
}
EXEMPT_NAMES = {
    # Pallas tiling constants of K1 and K2/K3: the CUDA kernels tile in
    # their own sources
    ("kernels/fused_field.py", "TILE"),
    ("kernels/fused_field.py", "NSPLIT"),
    ("kernels/fused_field_train.py", "TILE_F"),
    ("kernels/fused_field_train.py", "TILE_B"),
    # the raw pallas_call of K2 on packed inputs; the port launches K2
    # and K3 through train_forward / train_backward
    ("kernels/fused_field_train.py", "fused_field_train"),
    # an alias of jax.lax.stop_gradient; tensors have .detach()
    ("render/renderer.py", "stop"),
    # a host-clock phase logger nothing called (no device sync); the port
    # names its phases with the profiler spans of the same module
    ("utils/timing.py", "time_measure"),
}


def _public(path: pathlib.Path, exported: bool) -> set[str]:
    """Top-level public defs and assignments, plus imported names when
    `exported` (a package __init__)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif exported and isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_exemptions_name_real_modules_and_names():
    assert EXEMPT_MODULES <= set(MODULES)
    for module, name in EXEMPT_NAMES:
        assert name in _public(JAX_PKG / module, False), (module, name)


@pytest.mark.parametrize("module", MODULES)
def test_module_has_a_counterpart(module):
    if module in EXEMPT_MODULES:
        assert not (PORT_PKG / module).exists()
        return
    port = PORT_PKG / module
    assert port.exists(), f"ibl_nerf_tpu_torch/{module} is missing"
    init = module.endswith("__init__.py")
    want = _public(JAX_PKG / module, init) - {n for m, n in EXEMPT_NAMES if m == module}
    have = _public(port, True)
    assert not want - have, f"{module}: no counterpart of {sorted(want - have)}"
