"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for
``sm_90a``, into a shared library with a plain C interface under
``kernels/build/`` (listed in ``.gitignore``).  The library's file name
carries a hash of its source and of the shared headers (``csrc/*.cuh``),
so an edited source or header rebuilds and a stale library is never
loaded.  ``build_all`` runs one ``nvcc`` per source, all at once.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((pathlib.Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 pathlib.Path("/usr/local/cuda/bin/nvcc")):
        if cand and pathlib.Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path.  Raises with nvcc's output on failure."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)       # atomic: a concurrent loader sees all or none
    return out


def build_all(names) -> list[pathlib.Path]:
    """``build`` each name, every ``nvcc`` started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library for ``csrc/<name>.cu``;
    callers keep the handle."""
    return ctypes.CDLL(str(build(name)))
