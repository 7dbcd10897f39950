"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled by
``nvcc`` into ``_build/lib<name>-<hash>.so`` inside the package (the hash
covers the source and the flags, so an edited kernel rebuilds) at first
use, and loaded with ``ctypes``. Nothing is compiled when the package is
imported, and a failed build raises: there is no fallback.

Flags: ``sm_90a`` (Hopper), no ``--use_fast_math``, and ``-fmad=false``
so that no multiply-add is contracted — the kernels then round exactly
like their plain PyTorch versions, which compute one operation per
tensor op.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, NamedTuple, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc / ptxas output (registers, spills) of a fresh build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the dynslam_tpu_torch kernels")


def build(name: str, csrc_dir: Path = CSRC_DIR) -> BuildResult:
    """Compile ``<csrc_dir>/<name>.cu`` (default: the package's own
    ``csrc/``; another checkout's, to time an earlier commit's kernel)
    unless a library of the same source and flags exists. Raises
    RuntimeError with nvcc's output on failure."""
    src = Path(csrc_dir) / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {src.name} (rc {res.returncode}):\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return BuildResult(out, seconds, (res.stdout + res.stderr).strip())


#: version of the C entries' argument lists: every ``csrc/*.cu`` exports
#: ``int dynslam_abi_version()`` returning it (the libraries built before
#: it existed export none and are version 1); change it and the sources
#: together
ABI_VERSION = 2


def abi_version(path: Path) -> int:
    """The C ABI version of the kernel library at ``path``."""
    lib = ctypes.CDLL(str(path))
    if not hasattr(lib, "dynslam_abi_version"):
        return 1
    lib.dynslam_abi_version.restype = ctypes.c_int
    return lib.dynslam_abi_version()


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def load(path: Path, name: str, signature: str):
    """The C entry ``name`` of the shared library at ``path``, with
    ``argtypes`` from ``signature``: one letter per argument, ``p``
    pointer (pass ``tensor.data_ptr()``, the stream handle, or None for a
    null pointer), ``i`` int, ``f`` float. It returns a ``cudaError_t``."""
    fn = getattr(ctypes.CDLL(str(path)), name)
    fn.argtypes = [_CTYPES[c] for c in signature.replace(" ", "")]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def function(lib: str, name: str, signature: str):
    """The C entry ``name`` of kernel library ``lib`` (built and loaded on
    first use); see ``load``."""
    return load(build(lib).path, name, signature)


class Launch(NamedTuple):
    """One C call with its arguments prepared: calling it runs the kernel
    (and nothing else) on the stream it was prepared for and returns the
    ``cudaError_t``. ``keep`` holds the tensors whose pointers ``args``
    carries."""

    fn: Any
    args: Tuple
    keep: Tuple

    def __call__(self) -> int:
        return self.fn(*self.args)


def check_launch(err: int, kernel: str) -> None:
    """Raise if a kernel's C entry returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")
