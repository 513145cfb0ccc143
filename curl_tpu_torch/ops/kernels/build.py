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

A source may include headers generated at build time (`headers`: file name
-> text, such as K1's per-degree `trispace_tables.h`). They are written into
`build/curl_tpu_torch/<name><tag>-<hash>.include/`, which is put on nvcc's
include path, and their text is part of the hash; `tag` names the variant in
the library's name (`libtrispace_kernel_d4-<hash>.so`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Mapping, Optional

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


def _source_hash(name: str, headers: Mapping[str, str]) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    for file, text in sorted(headers.items()):
        h.update(file.encode())
        h.update(text.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str, tag: str = "", headers: Optional[Mapping[str, str]] = None) -> Path:
    return BUILD_DIR / f"lib{name}{tag}-{_source_hash(name, headers or {})}.so"


def ptxas_report(name: str, tag: str = "", headers: Optional[Mapping[str, str]] = None) -> str:
    """The `-Xptxas -v` output of the current build of `name` ("" if none)."""
    path = library_path(name, tag, headers).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def _write_atomic(path: Path, text: str) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def build(name: str, tag: str = "", headers: Optional[Mapping[str, str]] = None) -> Path:
    """Compile csrc/<name>.cu (with the generated `headers`) unless a
    library of the same sources exists."""
    headers = headers or {}
    lib = library_path(name, tag, headers)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    include = ["-I", str(CSRC)]
    if headers:
        gen = lib.with_name(lib.name[len("lib"):-len(".so")] + ".include")
        gen.mkdir(exist_ok=True)
        for file, text in headers.items():
            _write_atomic(gen / file, text)
        include += ["-I", str(gen)]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *include, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}{tag} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    _write_atomic(lib.with_suffix(".ptxas.txt"), proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(name: str, tag: str = "", headers: Optional[Mapping[str, str]] = None) -> ctypes.CDLL:
    """Load the library of csrc/<name>.cu, building it first if needed."""
    return ctypes.CDLL(str(build(name, tag, headers)))
