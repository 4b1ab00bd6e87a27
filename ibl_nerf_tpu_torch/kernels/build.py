"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` has a plain C interface and is compiled by
`nvcc` for sm_90a into `build/torch_kernels/lib<name>_<hash>.so` under
the checkout (git-ignored), then loaded with ctypes. The hash covers
the sources and the flags, so an edited source is rebuilt. `build()`
starts one nvcc per source, all at once, and waits for them together.
Nothing is built at import: the first launch, or an explicit
`build()`, does it.

`build_native()` does the same with g++ for the repo's native data
loader (`native/ibl_data.cc`, a PNG decoder on zlib), into
`build/native/`; the source directory is only read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NATIVE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "ibl_data.cc"
NATIVE_DIR = BUILD_DIR.parent / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
CXX_LIBS = ("-lz", "-pthread")
SOURCES = ("fused_field", "fused_field_train", "fused_field_bf16", "fused_field_f64")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, Path]:
    """Compile every named source not yet built, in parallel. Returns
    {name: library path}; the compiler's output (`-Xptxas -v`: registers,
    shared memory, spills) lands in `build_logs`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {name: _lib_path(name) for name in names}
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{out}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build((name,))[name]))
    return _loaded[name]


def build_native(source: Path = NATIVE_SOURCE) -> Path:
    """Compile the native data loader with g++ unless built already;
    returns the library's path. Raises with the compiler's output when
    g++ or zlib's header is missing."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + CXX_LIBS).encode())
    h.update(source.read_bytes())
    lib = NATIVE_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data loader cannot be built")
    NATIVE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp), *CXX_LIBS],
                          capture_output=True, text=True)
    build_logs[source.stem] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib
