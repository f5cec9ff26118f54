"""The condition of a compiled loop on the card (``csrc/loop_cond.cu``):
one pass of a captured loop (prologue, steps, epilogue) in one launch,
with no host read inside it.

``graphs.drive`` and ``graphs.drive_lanes`` are the kernel's boundary and
make its one decision: a ``graphs.Graphs`` whose pass fits on the card
(``Graphs.loops``: looped, at most ``graphs.PASS_OPS`` device operations)
runs ``run_pass(g, cap, rule)``, unless ``LOOP_COND.through_the_twin()``
holds; every other runner takes the plain twin, ``graphs.host_pass``
(``LOOP_COND.twin``), which runs the same pass with the loop on the host:
part by part, one host read of the flag per step.  Rule "done" reads the
state's done flag (a bool), rule "left" its ``left`` (int64 (2,), whose
first entry counts the lanes still running); ``cap`` is the most steps a
pass runs.  ``run_pass`` launches the configuration's pass graph for
(cap, rule), built at first use from the captured parts: one IF node,
always taken, whose body holds the prologue, step 1 and the condition
kernel, steps 2 to cap each with its condition kernel in the body of an IF
node nested in the one before, and the epilogue (``csrc/loop_cond.cu``
says why not a WHILE node).  Both run the same parts in the same order,
so every output is bit-equal between them.

The kernel's launches, one per step a pass ran, count at the next
``graphs.settle`` with the steps' other kernels.
"""
from __future__ import annotations

import ctypes
import functools
import time
import weakref

import torch

from .. import cuda_build, graphs

RULES = {"done": (0, torch.bool, ()), "left": (1, torch.int64, (2,))}
_P = ctypes.c_void_p


def run_pass(g, cap: int, rule: str) -> None:
    """One pass of the looped configuration ``g`` on the card, in one
    launch of its pass graph for (cap, rule)."""
    flag = getattr(g.state, rule)
    code, dtype, shape = RULES[rule]
    if flag.dtype != dtype or tuple(flag.shape) != shape:
        raise TypeError(f"loop_cond: rule {rule!r} reads a {dtype} flag of "
                        f"shape {shape}, got {flag.dtype} "
                        f"{tuple(flag.shape)}")
    LOOP_COND.watch(g, cap, rule)
    key = (cap, rule, flag.data_ptr())
    pass_graph = g.passes.get(key)
    if pass_graph is None:
        pass_graph = g.passes[key] = _PassGraph(g, flag, code, cap)
    g.run_pass(pass_graph)


# its boundary is ``graphs.drive``, which calls ``run_pass`` or the twin
LOOP_COND = cuda_build.Kernel(
    "loop_cond", "loop_cond.cu", "dcreg_loop_pass",
    [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
     ctypes.POINTER(_P)],
    twin=graphs.host_pass, on_card=None)


@functools.cache
def _launch_and_free():
    return (LOOP_COND.function("dcreg_loop_launch", [_P, _P]),
            LOOP_COND.function("dcreg_loop_free", [_P]))


class _PassGraph:
    """The instantiated pass graph of one looped configuration ``g``,
    cap and rule (``dcreg_loop_pass``); its build time counts as
    capture time.  ``replay()`` launches it on the current stream."""

    def __init__(self, g, flag, code: int, cap: int):
        t0 = time.perf_counter()
        make = LOOP_COND._bound()
        launch, free = _launch_and_free()
        raw = [_P(g.graphs[n].raw_cuda_graph())
               for n in ("prologue", "step", "epilogue")]
        index = g.device.index if g.device.index is not None \
            else torch.cuda.current_device()
        exe = _P()
        rc = make(*raw, _P(flag.data_ptr()), code, cap,
                  _P(g.step_count.data_ptr()), index, ctypes.byref(exe))
        if rc != 0:
            raise RuntimeError(f"loop_cond: the pass graph of {g.label} "
                               f"(cap {cap}) failed to build: cudaError {rc}"
                               " (conditional nodes need CUDA 12.4 or "
                               "later)")
        self.exe, self._launch, self.device = exe, launch, g.device
        weakref.finalize(self, free, exe)
        seconds = time.perf_counter() - t0
        g.seconds += seconds
        graphs.CACHE.capture_seconds += seconds

    def replay(self) -> None:
        rc = self._launch(self.exe, _P(torch.cuda.current_stream(
            self.device).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"loop_cond pass launch failed: cudaError "
                               f"{rc}")
