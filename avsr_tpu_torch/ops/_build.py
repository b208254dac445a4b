"""Builds the port's CUDA sources into shared libraries with a C interface.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into ``build/lib<name>-<hash>.so`` (the hash covers the sources and the
flags, so an edited kernel is rebuilt and a stale library is never
loaded), then opened with ``ctypes``. The build runs at first use, on the
machine with the card; nothing is compiled when a module is imported.
``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
KERNEL_SOURCES = ("flash_fwd", "flash_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output of each build made by this process (ptxas register and
# shared-memory report), by source name.
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of avsr_tpu_torch are compiled at "
        "first use and need the CUDA toolkit (put nvcc on PATH or set "
        "CUDA_HOME)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


def build_all(names: tuple[str, ...] = KERNEL_SOURCES) -> None:
    """Build every kernel source in parallel, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for fut in [pool.submit(build, n) for n in names]:
            fut.result()


def load(name: str) -> ctypes.CDLL:
    """The opened library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build(name)))
    return lib
