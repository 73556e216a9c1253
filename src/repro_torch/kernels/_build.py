"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``.cu`` under ``repro_torch/csrc/`` goes into one shared library with
a plain C interface, compiled by one ``nvcc`` call for ``sm_90a`` into
``build/kernels/`` at the repository root (git-ignored) the first time a
kernel is launched. The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded;
nothing built is committed. ``nvcc``'s report (``-Xptxas -v``: registers,
shared memory, spills per kernel) is kept beside the library.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on a non-zero code: a refused launch never runs, and a
later ``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or DEFAULT_NVCC
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> pathlib.Path:
    """Compile the library unless it exists for the current sources and
    flags; returns its path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libkernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    sources = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *sources],
        capture_output=True, text=True, check=False,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stderr[-6000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def entry(name: str, argtypes: list):
    """A C entry point of the library with its argument types declared.
    Pointers and the stream must be ``ctypes.c_void_p``: an undeclared
    argument is passed as a 32-bit int and a pointer would be cut."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(code: int, kernel: str) -> None:
    if code != 0:
        msg = library().kernel_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch: {msg}")
