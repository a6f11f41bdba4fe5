"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled, at first
use, into ``build/margipose_tpu_torch/lib<name>-<hash>.so`` at the root of
the checkout (git-ignored). The hash is of the source, so an edited kernel is
rebuilt and a stale library is never loaded. Nothing is built or loaded when
this module is imported: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from os import path

_PKG = path.dirname(path.dirname(path.abspath(__file__)))
CSRC = path.join(_PKG, "csrc")
BUILD_DIR = path.join(path.dirname(_PKG), "build", "margipose_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> str:
    with open(path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, temp output, final output)."""
    out = library_path(name)
    if path.isfile(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, path.join(CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names) -> None:
    """Build the named kernels' libraries, one nvcc per source, all started
    together. Raises with the compiler's output if any build fails."""
    started = [(n, *_start_build(n)) for n in names]
    errors = []
    for name, proc, tmp, out in started:
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a half-written .so is never loaded
    if errors:
        raise RuntimeError("\n".join(errors))


def kernel_sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
