"""Build and load the CUDA C++ kernels of ``csrc/``.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded through ``ctypes``. The library is built on first use
into ``_build/`` beside this file, under a name that hashes the source, the
shared headers of ``csrc/`` and the flags, so an edited source or header is
rebuilt and concurrent builds do not clobber each other (each writes a
private file and renames it into place).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
    "-lineinfo",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` is (or will be) built."""
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{key}.so"


def build(source: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<source>`` unless it is built already.

    Returns ``(library, seconds, compiler log)``; seconds and log are 0 and
    the saved log when the library was already there.
    """
    out = library_path(source)
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    start = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        capture_output=True,
        text=True,
    )
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, seconds, log


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    path, _, _ = build(source)
    lib = ctypes.CDLL(str(path))
    lib.bsi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bsi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if code != 0:
        message = lib.bsi_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({message})")
