"""Build the port's hand-written CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles on its own into a shared library with a plain C
interface, bound with ``ctypes`` by the module that launches it.  One
command for every source: ``nvcc -gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 --fmad=false -Xptxas -v -shared -Xcompiler -fPIC``.
``--fmad=false`` keeps every kernel's float arithmetic in the order its
plain PyTorch twin computes it, so the two agree bit for bit; ``-Xptxas
-v`` reports registers and spills, returned as the build's log.  The
library lands in ``<build_dir>/<sha256 of the source, 16 hex>/``, so an
edited source builds anew and an unchanged one is reused.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]


def nvcc(kernel: str) -> str:
    """Path of nvcc (PATH, then /usr/local/cuda/bin); ``kernel`` names the
    kernel in the error raised when there is none."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(f"nvcc not found: the {kernel} kernel cannot be "
                           "built")
    return path


def build_library(source: Path, name: str, kernel: str,
                  build_dir: Path = BUILD_DIR) -> dict:
    """Compile ``source`` into ``build_dir/<source hash>/lib<name>.so``
    unless that file already exists.  Returns {"path", "seconds", "log"}
    (log: the nvcc/ptxas output of a fresh build)."""
    src = Path(source).read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    out_dir = Path(build_dir) / digest
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    compiler = nvcc(kernel)
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".tmp_{os.getpid()}_{name}.so"
    cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "log": (proc.stdout + proc.stderr).strip()}
