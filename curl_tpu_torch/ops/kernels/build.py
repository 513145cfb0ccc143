"""Build the port's CUDA kernels from the package's `csrc/` sources at first
use and load them with ctypes.

Each kernel source is compiled by `nvcc` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/curl_tpu_torch/lib<name>-<hash>.so \
         curl_tpu_torch/csrc/<name>.cu

without fast math. The library name carries a hash of the sources, so an
edited source is rebuilt and an unchanged one is loaded as it is. The
output of `-Xptxas -v` (registers, shared memory and spills per kernel) is
kept beside the library as `<name>-<hash>.ptxas.txt`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "curl_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
            "the CUDA kernels are built from source at first use"
        )
    return found


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)}.so"


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` output of the current build of `name` ("" if none)."""
    path = library_path(name).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same sources exists."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """Load the library of csrc/<name>.cu, building it first if needed."""
    return ctypes.CDLL(str(build(name)))
