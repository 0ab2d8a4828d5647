"""Build the port's CUDA sources with ``nvcc`` at first use, load them with
``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain ``extern "C"`` interface (no PyTorch headers, so a build takes seconds)
for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

into ``dsabeamformer_tpu_torch/build/`` (git-ignored).  The file name
carries a hash of the sources and flags, so an edited source is rebuilt and
a stale library is never loaded.  ``ptxas -v`` (registers, shared memory,
spills per kernel) is kept beside the library as ``.log``.

Importing this module runs nothing: it works on a machine with no ``nvcc``
and no card, where only the CPU paths of the port are reachable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}  # name -> ctypes.CDLL, one load per process


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); raises ``RuntimeError`` if there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin: the port's CUDA kernels "
        "are built at first use on a machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path."""
    so = _library_path(name)
    if so.is_file():
        return so
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src}:\n"
            f"{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def build_log(name: str) -> str:
    """The compiler's output (``ptxas -v``) from building ``name``."""
    return _library_path(name).with_suffix(".log").read_text()


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
