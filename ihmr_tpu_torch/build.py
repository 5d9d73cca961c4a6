"""Build the port's CUDA sources and load them with ctypes.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/ihmr_tpu_torch/`` beside the package, named by a hash of the source
and the flags, so an unchanged source is built once. Building happens at
first use (``load_library``) or up front for every source in parallel
(``build_all``, one ``nvcc`` process per source).

    python -m ihmr_tpu_torch.build     # build every kernel, print ptxas usage
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "ihmr_tpu_torch"

# kernel name -> source, relative to the package
SOURCES: Dict[str, str] = {
    "exact_collision": "csrc/exact_collision.cu",
    "nearest_centroid": "csrc/nearest_centroid.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (PACKAGE_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named source (default: all) that is not built yet, all
    nvcc processes started together. Returns {name: {"seconds", "log"}};
    raises with nvcc's output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(PACKAGE_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    report = {name: {"seconds": 0.0, "log": "already built"} for name in names if name not in procs}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


if __name__ == "__main__":
    for kernel, info in build_all().items():
        print(f"{kernel}: {info['seconds']:.1f}s\n{info['log']}")
