"""Build ``fastio.cpp`` into a shared library with a plain C ABI and load
it with ``ctypes``.

The library goes to ``dynslam_tpu_torch/_build/libfastio-<hash>.so``,
the hash covering the source and the flags, at first use (never when a
module is imported), as ``ops/cuda_build.py`` builds the kernels. A
failed build raises with the compiler's output. By hand::

    python -m dynslam_tpu_torch.native.build
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "fastio.cpp"
BUILD_DIR = HERE.parent / "_build"
#: the C++ compiler (``nvcc`` needs it, so the card's machine has it)
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()


def library_path(build_dir=None) -> Path:
    """Where the library of this source and these flags lives (in
    ``build_dir``, default ``BUILD_DIR``)."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return Path(build_dir or BUILD_DIR) / \
        f"libfastio-{digest.hexdigest()[:16]}.so"


def build(build_dir=None, compiler: str = "") -> tuple:
    """Compile the library with ``compiler`` (default ``CXX``) unless it
    exists: (path, seconds the build took, 0.0 when it was there).
    Raises RuntimeError with the compiler's output when the build
    fails."""
    out = library_path(build_dir)
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    cmd = [compiler or CXX, *FLAGS, "-o", str(tmp), str(SRC)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"fastio: cannot run {cmd[0]!r}: {e}") from e
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"fastio: {' '.join(cmd)} failed (rc "
                           f"{res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, seconds


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_PATH = ctypes.c_char_p
#: argument types of each C entry
SIGNATURES = {
    "fastio_abi_version": (),
    "fastio_read_text_mask": (_PATH, _I, _I, _P, _P),
    "fastio_pfm_header": (_PATH, _P, _P),
    "fastio_read_pfm": (_PATH, _I64, _I64, _I64, _I64, _I, _P),
    "fastio_read_file": (_PATH, _P, _I64),
    "fastio_png_unfilter": (_P, _I64, _P, _I64, _I, _I, _I, _P, _P),
}


def load(build_dir=None, compiler: str = ""):
    """The library (built first if need be) as a ``ctypes.CDLL`` with
    every entry's argument types set. ``CDLL`` calls release the
    interpreter lock."""
    with _lock:
        path, _ = build(build_dir, compiler)
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(args), ctypes.c_int
    return lib


if __name__ == "__main__":
    path, seconds = build()
    print(f"built {path} in {seconds:.2f} s")
