"""Build and load the port's native libraries (nvcc or g++, then ctypes).

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host code)
exposes a plain C interface and is compiled, at first use, into
``build/margipose_tpu_torch/lib<name>-<hash>.so`` at the root of the checkout
(git-ignored): ``.cu`` by nvcc for ``sm_90a``, ``.cpp`` by g++ with the JAX
package's host-ops flags. The hash is of the source, the flags, the
compiler's version banner and the host (name, machine, libc), so an edited
source is rebuilt, and a library built by another compiler or on another
machine (a ``build/`` copied along with a checkout) is never loaded. Nothing
is built or loaded when this module is imported: the CPU tests import every
module.

``KERNELS`` declares every C entry point of the hand-written kernels, by
symbol (``Kernel``): its library, its arguments and the names its kernels
run under in a device trace. Calling one launches it and counts the launch;
``launch_counts`` and ``zero_launch_counts`` read and zero the counts. A
tensor takes a kernel where ``takes_kernel`` says so, on a CUDA device;
everywhere else the wrapper runs its plain version, and on CUDA there is no
fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from os import path

import torch

_PKG = path.dirname(path.dirname(path.abspath(__file__)))
CSRC = path.join(_PKG, "csrc")
BUILD_DIR = path.join(path.dirname(_PKG), "build", "margipose_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# the flags of the JAX package's host-ops build (native/build.sh), so that
# both libraries give the same bits
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/ at first use")


def _gxx() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise RuntimeError("g++ not found on PATH; the port's host ops are built from "
                           "csrc/host_ops.cpp at first use (MARGIPOSE_DISABLE_NATIVE=1 "
                           "selects the PIL path)")
    return cand


def _source(name: str) -> tuple[str, list[str]]:
    """(source path, compiler flags) of ``name``: its ``.cu`` or ``.cpp``."""
    cu = path.join(CSRC, f"{name}.cu")
    if path.isfile(cu):
        return cu, NVCC_FLAGS
    return path.join(CSRC, f"{name}.cpp"), GXX_FLAGS


def _compiler(src: str) -> str:
    return _nvcc() if src.endswith(".cu") else _gxx()


@functools.lru_cache(maxsize=None)
def _toolchain(compiler: str) -> str:
    """The compiler's version banner and the host it runs on."""
    banner = subprocess.run([compiler, "--version"], capture_output=True, text=True,
                            check=True).stdout
    return "\n".join([banner, platform.node(), platform.machine(), *platform.libc_ver()])


def library_path(name: str) -> str:
    src, flags = _source(name)
    with open(src, "rb") as f:
        key = f.read() + " ".join(flags).encode() + _toolchain(_compiler(src)).encode()
    return path.join(BUILD_DIR, f"lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start the compiler for ``name`` unless its library exists; returns
    (process or None, temp output, final output)."""
    out = library_path(name)
    if path.isfile(out):
        return None, None, out
    src, flags = _source(name)
    compiler = _compiler(src)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    proc = subprocess.Popen([compiler, *flags, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names) -> None:
    """Build the named libraries, one compiler per source, all started
    together. Raises with the compiler's output if any build fails."""
    started = [(n, *_start_build(n)) for n in names]
    errors = []
    for name, proc, tmp, out in started:
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{path.basename(_source(name)[0])} failed to build:\n{log}")
            continue
        # atomic: a half-written .so is never loaded, and processes that race
        # on one build (forked loader workers) each rename a whole library
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def kernel_sources() -> list[str]:
    """The CUDA kernels' names (``csrc/*.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


def takes_kernel(device: torch.device) -> bool:
    """Whether a tensor on ``device`` takes the hand-written kernel (CUDA)
    rather than the plain version (every other device)."""
    return device.type == "cuda"


@dataclasses.dataclass(eq=False)
class Kernel:
    """One C entry point of ``csrc/<library>.cu``: ``symbol(*argtypes,
    stream)`` returns a CUDA error code, and launches kernels that a device
    trace names with one of ``traced`` once a launch. ``launches`` counts the
    host launches that returned 0 since the last ``zero_launch_counts``."""

    library: str
    symbol: str
    argtypes: tuple
    traced: tuple[str, ...]
    launches: int = 0
    _fn: object = dataclasses.field(default=None, repr=False)

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raises on a non-zero
        return, without counting it."""
        if self._fn is None:  # bound at first use: importing builds nothing
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes, fn.restype = [*self.argtypes, ctypes.c_void_p], ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):  # the tensors' card, not the current one
            err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} kernel launch failed: CUDA error {err}")
        self.launches += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U64S = ctypes.POINTER(ctypes.c_uint64)  # a launch's G groups' pointers

KERNELS = {k.symbol: k for k in (
    Kernel("dsnt_jsd", "dsnt_jsd_fwd", (_U64S, _U64S, _I, _P, _I, _I, _I, _F, _F),
           ("dsnt_jsd_fwd_kernel",)),
    Kernel("dsnt_jsd", "dsnt_jsd_bwd", (_U64S, _U64S, _I, _P, _P, _I, _I, _I, _F, _F),
           ("dsnt_jsd_bwd_kernel",)),
    Kernel("dsnt_jsd", "dsnt_jsd_log_check", (_P,), ("log_normal_check_kernel",)),
    Kernel("softargmax3d", "softargmax3d_fwd", (_P, _I, _I, _I, _I, _I, _P, _P),
           ("softargmax3d_fwd_kernel",)),
    Kernel("softargmax3d", "softargmax3d_bwd", (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I),
           ("softargmax3d_bwd_kernel",)),
    # a split path's partial kernel runs beside its apply kernel: the apply
    # kernel counts the launch
    Kernel("batch_norm", "batch_norm_train_fwd",
           (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _P),
           ("batch_norm_train_fwd_kernel", "batch_norm_train_fwd_apply_kernel")),
    Kernel("batch_norm", "batch_norm_train_bwd",
           (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
           ("batch_norm_train_bwd_kernel", "batch_norm_train_bwd_apply_kernel")),
)}


def launch_counts(*symbols: str) -> dict[str, int]:
    """Host launches of the named entry points (every one where none is
    named) since they were last zeroed."""
    return {s: KERNELS[s].launches for s in symbols or KERNELS}


def zero_launch_counts(*symbols: str) -> None:
    """Zero the named entry points' launch counts (every one where none is
    named)."""
    for s in symbols or KERNELS:
        KERNELS[s].launches = 0
