"""Build the port's native libraries at first use: the hand-written CUDA
kernels (``csrc/*.cu``) and the host runtime (``native/dcreg_native.cpp``),
and ``Kernel``, the one boundary every hand-written kernel goes through.

Each source compiles on its own into a shared library with a plain C
interface, bound with ``ctypes``.  One
command for every CUDA source: ``nvcc -gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 --fmad=false -Xptxas -v -shared -Xcompiler -fPIC``.
``--fmad=false`` keeps every kernel's float arithmetic in the order its
plain PyTorch twin computes it, so the two agree bit for bit; ``-Xptxas
-v`` reports registers and spills, returned as the build's log.  The host
runtime takes ``g++`` with the flags of ``native/Makefile``.  A library
lands in ``<build_dir>/<sha256 of the source, 16 hex>/``, so an edited
source builds anew and an unchanged one is reused; nothing is written
beside a source.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib
import os
import pkgutil
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import graphs

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
# native/Makefile's CXXFLAGS and link step
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]


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
    """Compile the CUDA ``source`` into ``build_dir/<source hash>/
    lib<name>.so`` unless that file already exists.  Returns {"path",
    "seconds", "log"} (log: the nvcc/ptxas output of a fresh build)."""
    return _compile(source, name, build_dir,
                    lambda: [nvcc(kernel), *NVCC_FLAGS])


def build_host_library(source: Path, name: str,
                       build_dir: Path = BUILD_DIR) -> dict:
    """``build_library`` for a C++ host source, with g++."""
    def compiler():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found: lib{name} cannot be built")
        return [cxx, *CXX_FLAGS]
    return _compile(source, name, build_dir, compiler)


def _compile(source, name, build_dir, command) -> dict:
    src = Path(source).read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    out_dir = Path(build_dir) / digest
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    cmd = command()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".tmp_{os.getpid()}_{name}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed on {source} "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "log": (proc.stdout + proc.stderr).strip()}


class Kernel:
    """One hand-written CUDA kernel behind its boundary function.

    ``label`` names it in errors (K1, K2, K3, pcg6, plane_fit, schur6,
    loop_cond).  Its ``source`` under ``csrc/`` builds into
    ``libdcreg_<source stem>.so`` (``build``; the kernels of one source
    share its library), whose C function ``symbol`` takes ``argtypes``
    (a CUDA stream last, where ``launch`` calls it) and returns a
    cudaError; it is bound on first use (``function`` binds the
    library's other C functions).

    A call ``kernel(*operands)`` is the boundary's one rule: operands on
    the CPU take the plain PyTorch twin ``twin``; on the card
    ``on_card(*operands)`` checks them and launches the kernel through
    ``launch``, or raises.  Nothing falls back.  Both take the boundary's
    own arguments, the first a tensor on the call's device.  (loop_cond's
    boundary is ``graphs.drive``, which decides itself between its
    ``twin``, ``graphs.host_pass``, and ``ops/loop_cond.run_pass``; it has
    no ``on_card``.)

    Counters: ``launches`` (through ``graphs.note_launch``: a launch
    inside a captured graph counts once per replay, and once per step a
    pass on the card ran), ``launches_replayed`` (those of them made by
    replays), ``launches_by_kk`` (per kk, where the launch names one) and
    ``last_grid`` (the grid of the last launch, where it records one).
    Reading one of the first three counts the steps of the passes driven
    on the card since the last read first (``graphs.settle``).
    ``through_the_twin`` and ``watching`` serve checks of the kernel
    inside a whole program."""

    def __init__(self, label: str, source: str, symbol: str, argtypes,
                 twin, on_card):
        self.label, self.source = label, CSRC / source
        self.symbol, self.argtypes = symbol, argtypes
        self.twin, self.on_card = twin, on_card
        self._launches = self._launches_replayed = 0
        self._launches_by_kk = {}
        self.last_grid = None
        self._fn = None
        self._twin_route = False
        self._watchers = []

    def build(self) -> dict:
        """Compile the source with the shared nvcc command unless
        ``_build/<source hash>/`` already holds its library.  Returns
        {"path", "seconds", "log"}."""
        return build_library(self.source, f"dcreg_{self.source.stem}",
                             self.label, BUILD_DIR)

    @property
    def launches(self) -> int:
        graphs.settle()
        return self._launches

    @property
    def launches_replayed(self) -> int:
        graphs.settle()
        return self._launches_replayed

    @property
    def launches_by_kk(self) -> dict:
        graphs.settle()
        return self._launches_by_kk

    def function(self, symbol: str, argtypes):
        """The C function ``symbol`` of the kernel's library (built
        first), taking ``argtypes`` and returning a cudaError."""
        fn = getattr(ctypes.CDLL(self.build()["path"]), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def _bound(self):
        if self._fn is None:
            self._fn = self.function(self.symbol, self.argtypes)
        return self._fn

    def sm_count(self, device) -> int:
        """The SM count of ``device``, which sizes a grid; the library is
        bound first, so that a device with no kernel to launch raises the
        build's error."""
        self._bound()
        return torch.cuda.get_device_properties(device).multi_processor_count

    def launch(self, *args, device, kk=None, grid=None) -> None:
        """Launch the kernel with ``args`` on ``device``'s current stream
        and count the launch (under ``kk``; ``grid`` becomes
        ``last_grid``).  Raises where the launch fails."""
        rc = self._bound()(*args, torch.cuda.current_stream(device)
                           .cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.label} kernel launch failed: "
                               f"cudaError {rc}")
        graphs.note_launch(self, kk)
        if grid is not None:
            self.last_grid = grid

    def __call__(self, *operands):
        if operands[0].device.type == "cpu" or self._twin_route:
            return self.twin(*operands)
        self.watch(*operands)
        return self.on_card(*operands)

    @property
    def on_twin_route(self) -> bool:
        """Whether ``through_the_twin`` holds."""
        return self._twin_route

    def watch(self, *operands) -> None:
        """Show the operands of a call on the card to the watchers
        (``watching``)."""
        for fn in self._watchers:
            fn(*operands)

    @contextlib.contextmanager
    def through_the_twin(self):
        """Within the block, calls on the card take the plain twin too
        (building nothing), for holding a program against the kernel's
        twin.  A captured graph keeps the launches it captured: run the
        program eagerly."""
        was, self._twin_route = self._twin_route, True
        try:
            yield self
        finally:
            self._twin_route = was

    @contextlib.contextmanager
    def watching(self, fn):
        """Within the block, ``fn(*operands)`` sees the operands of every
        call on the card before the kernel launches on them."""
        self._watchers.append(fn)
        try:
            yield self
        finally:
            self._watchers.remove(fn)


def kernels() -> list:
    """Every ``Kernel`` declared in a module of ``dcreg_tpu_torch.ops``."""
    from . import ops
    found = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for v in vars(mod).values():
            if isinstance(v, Kernel):
                found[id(v)] = v
    return list(found.values())
