"""Build and load the CUDA C++ kernels (plain C interface, ``ctypes``).

Each source under ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library at first use. The library's file name
carries a hash of the source, the headers beside it (``*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.

The build directory is ``$REPRO_TORCH_BUILD_DIR`` when that is set;
otherwise ``build/repro_torch/`` at the root of the checkout when the
package runs from one (``<root>/src/repro_torch``); otherwise, for an
installed package, ``repro_torch/`` under ``$XDG_CACHE_HOME`` (default
``~/.cache``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    package = Path(__file__).resolve().parents[1]
    if package.parent.name == "src":                     # a checkout
        return package.parents[1] / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "repro_torch"


BUILD_DIR = _build_dir()
# every CUDA source of the port: one library each, built in parallel by
# ``chip_smoke.py``
SOURCES = ("block_sparse.cu", "paged_attention.cu", "flash_attention.cu",
           "grouped_block_sparse.cu", "ssd_scan.cu", "wanda_metric.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> tuple:
    """Compile ``csrc/<source>`` unless its library is current.
    Returns ``(library path, ptxas report)`` (the report is empty when
    nothing was compiled)."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built on first use."""
    lib = _LOADED.get(source)
    if lib is None:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        _LOADED[source] = lib
    return lib
