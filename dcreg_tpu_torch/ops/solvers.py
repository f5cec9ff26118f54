"""Degenerate-system handlers (counterpart of ``dcreg_tpu/ops/solvers.py``).

Every handler reuses the spectrum ``degeneracy.analyze`` computed; PCG
runs a fixed ``max_iter`` trips with a per-system ``done`` mask, so a
batch of systems advances together and each stops updating where it
converged.  The handling method is a static enum; the JAX module's
traced-int-code dispatch (one XLA compile for the whole method matrix)
has no counterpart here.  Batched over leading dimensions.

``solve_pcg_fast``, the map loop's solve, is a kernel boundary: a CUDA
tensor launches the hand-written kernel pcg6 (``csrc/pcg6.cu``, built on
first use with nvcc and bound with ctypes; one launch where the plain
form runs 637 small ops), a CPU tensor takes the plain PyTorch twin
``solve_pcg_fast_plain``.  The wrapper counts its launches through
``graphs.note_launch``, so a launch inside a captured CUDA graph counts
once per replay.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import cuda_build, graphs
from . import linalg
from .degeneracy import (DegeneracyAnalysis, DegeneracyThresholds,
                         HandlingMethod, _block_diag, _eye6_like,
                         adaptive_regularizer, targeted_preconditioner)

_EPS_SV = 1e-9


class SolveInfo(NamedTuple):
    P_preconditioner: torch.Tensor   # (..., 6, 6)
    W_adaptive: torch.Tensor         # (..., 6, 6)
    pcg_iterations: torch.Tensor     # (...,) int32 (-1 unless PCG ran)
    pcg_residual: torch.Tensor       # (...,)
    cond_PH: torch.Tensor            # (...,)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _spectral_solve(w, V, g):
    """x = V diag(1/w) V^T g on a cached eigenbasis."""
    safe = torch.abs(w) > 1e-300
    inv_w = torch.where(safe, 1.0 / torch.where(safe, w, torch.ones_like(w)),
                        0.0)
    return _mv(V, inv_w * _mv(V.transpose(-1, -2), g))


def solve_none(analysis: DegeneracyAnalysis, g):
    return _spectral_solve(analysis.eigenvalues_full,
                           analysis.eigenvectors_full, g)


def solve_solution_remapping(analysis: DegeneracyAnalysis, g):
    """Plain solve, then projection onto the non-degenerate eigenvectors."""
    x = solve_none(analysis, g)
    V = analysis.eigenvectors_full
    keep = ~analysis.degenerate_mask
    x_proj = _mv(V, _mv(V.transpose(-1, -2), x) * keep)
    deg = analysis.is_degenerate[..., None]
    x_out = torch.where(deg, x_proj, x)
    none_kept = ~torch.any(keep, dim=-1, keepdim=True)
    return torch.where(deg & none_kept, torch.zeros_like(x), x_out)


def solve_truncated_svd(analysis: DegeneracyAnalysis, g):
    """Truncated SVD pseudo-inverse; the mask (ascending eigen order)
    indexes the DESCENDING singular values, as the reference does."""
    sv = analysis.singular_values
    U = torch.flip(analysis.eigenvectors_full, dims=(-1,))
    keep = (sv > _EPS_SV) & ~analysis.degenerate_mask
    inv = torch.where(keep, 1.0 / torch.where(keep, sv, torch.ones_like(sv)),
                      0.0)
    x = _mv(U, inv * _mv(U.transpose(-1, -2), g))
    return torch.where(torch.any(keep, dim=-1, keepdim=True), x,
                       torch.zeros_like(x))


def solve_standard_regularization(analysis: DegeneracyAnalysis, g,
                                  gamma: float):
    """Tikhonov H + gamma I where degenerate, on H's eigenbasis."""
    shift = torch.where(analysis.is_degenerate, gamma, 0.0).to(g.dtype)
    return _spectral_solve(analysis.eigenvalues_full + shift[..., None],
                           analysis.eigenvectors_full, g)


def pcg_unrolled(H, g, P, max_iter: int, tol: float):
    """Preconditioned CG on H dx = g for a batch of systems, ``max_iter``
    trips, iterating until |r| <= tol * |g|.  Returns (x, iterations
    (int32), final residual norm)."""
    x = torch.zeros_like(g)
    r = g
    z = _mv(P, r)
    p = z
    rz = _dot(r, z)
    thresh = tol * torch.clamp(torch.linalg.norm(g, dim=-1), min=1e-30)
    done = torch.zeros(g.shape[:-1], dtype=torch.bool, device=g.device)
    iters = torch.zeros(g.shape[:-1], dtype=torch.int32, device=g.device)
    one = torch.ones((), dtype=g.dtype, device=g.device)
    for _ in range(max_iter):
        Hp = _mv(H, p)
        pHp = _dot(p, Hp)
        safe = torch.abs(pHp) > 1e-30
        alpha = torch.where(safe & ~done,
                            rz / torch.where(safe, pHp, one), 0.0)
        x = x + alpha[..., None] * p
        r_new = r - alpha[..., None] * Hp
        z_new = _mv(P, r_new)
        rz_new = _dot(r_new, z_new)
        rz_ok = torch.abs(rz) > 1e-30
        beta = torch.where(rz_ok, rz_new / torch.where(rz_ok, rz, one), 0.0)
        p_new = z_new + beta[..., None] * p
        step_done = (torch.linalg.norm(r_new, dim=-1) <= thresh) | ~safe
        iters = iters + (~done).to(torch.int32)
        d = done[..., None]
        r = torch.where(d, r, r_new)
        z = torch.where(d, z, z_new)
        p = torch.where(d, p, p_new)
        rz = torch.where(done, rz, rz_new)
        done = done | step_done
    return x, iters, torch.linalg.norm(r, dim=-1)


def _schur_sqrt_precond(analysis: DegeneracyAnalysis, kappa_target: float):
    """P^(1/2) in closed form from the Schur EVDs."""
    def block(lam, V):
        lam_c = torch.maximum(lam, lam[..., 2:3] / kappa_target)
        s = 1.0 / torch.sqrt(torch.clamp(lam_c, min=1e-30))
        return (V * s[..., None, :]) @ V.transpose(-1, -2)

    S = _block_diag(block(analysis.lambda_schur_rot, analysis.V_schur_rot),
                    block(analysis.lambda_schur_trans,
                          analysis.V_schur_trans))
    ok = analysis.schur_valid & torch.all(torch.isfinite(S), dim=(-2, -1))
    return torch.where(ok[..., None, None], S, _eye6_like(S))


def _nan_like(g):
    return torch.full(g.shape[:-1], float("nan"), dtype=g.dtype,
                      device=g.device)


def _no_iters(g):
    return torch.full(g.shape[:-1], -1, dtype=torch.int32, device=g.device)


def solve_pcg_fast_plain(H, g, analysis: DegeneracyAnalysis,
                         thresholds: DegeneracyThresholds):
    """Plain PyTorch twin of pcg6: PRECONDITIONED_CG for the in-loop fast
    path, reading only the Schur fields; PCG where degenerate or where
    Cholesky fails, unrolled Cholesky otherwise."""
    P = targeted_preconditioner(analysis, thresholds.kappa_target)
    x_pcg, pcg_iters, pcg_resid = pcg_unrolled(
        H, g, P, thresholds.pcg_max_iter, thresholds.pcg_tolerance)
    x_chol, chol_ok = linalg.cholesky_solve_6x6(H, g)
    use_pcg = analysis.is_degenerate | ~chol_ok
    x = torch.where(use_pcg[..., None], x_pcg, x_chol)
    info = SolveInfo(
        P_preconditioner=P, W_adaptive=torch.zeros_like(H),
        pcg_iterations=torch.where(use_pcg, pcg_iters, _no_iters(g)),
        pcg_residual=torch.where(use_pcg, pcg_resid, _nan_like(g)),
        cond_PH=_nan_like(g))
    return x, info


# ---------------------------------------------------------------------------
# pcg6: build, bind, launch
# ---------------------------------------------------------------------------

CSRC = cuda_build.CSRC / "pcg6.cu"

# the kernel's operands in its order: (analysis field, or H and g;
# trailing shape); every one carries H's leading batch dimensions
_OPERANDS = (("H", (6, 6)), ("g", (6,)), ("lambda_schur_rot", (3,)),
             ("lambda_schur_trans", (3,)), ("V_schur_rot", (3, 3)),
             ("V_schur_trans", (3, 3)), ("schur_valid", ()),
             ("is_degenerate", ()))


def build_library() -> dict:
    """Compile ``csrc/pcg6.cu`` with the shared nvcc command
    (``cuda_build``) unless ``_build/<source hash>/`` already holds it.
    Returns {"path", "seconds", "log"}."""
    return cuda_build.build_library(CSRC, "dcreg_pcg6", "pcg6")


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_library()["path"])
    fn = lib.dcreg_pcg6
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, p, i, p, p, p, p, p, p, i, i,
                   ctypes.c_float, ctypes.c_float, p]
    fn.restype = i
    return lib


def kernel_operands(H, g, analysis: DegeneracyAnalysis):
    """(nb, views, strides): the kernel's eight operands with their
    leading batch dimensions merged into one of ``nb`` systems (a view of
    the caller's tensor wherever they merge, as they do for every
    caller's layout, so no copy runs), and their element strides in the
    kernel's order."""
    batch = tuple(H.shape[:-2])
    nb = math.prod(batch)
    views = []
    for name, tail in _OPERANDS:
        t = {"H": H, "g": g}.get(name)
        if t is None:
            t = getattr(analysis, name)
        if tuple(t.shape) != batch + tail:
            raise ValueError(f"pcg6: {name} has shape {tuple(t.shape)}, "
                             f"expected {batch + tail}")
        views.append(t.reshape((nb,) + tail))
    return nb, views, [s for v in views for s in v.stride()]


def _launch_cuda(H, g, analysis: DegeneracyAnalysis,
                 thresholds: DegeneracyThresholds):
    dev = H.device
    if dev.type != "cuda":
        raise ValueError(f"pcg6 runs on a CUDA device, got {dev}")
    nb, views, strides = kernel_operands(H, g, analysis)
    for (name, _), v in zip(_OPERANDS, views):
        want = (torch.bool if name in ("schur_valid", "is_degenerate")
                else torch.float32)
        if v.dtype != want or v.device != dev:
            raise TypeError(f"pcg6: {name} is {v.dtype} on {v.device}, "
                            f"expected {want} on {dev}")
    batch = H.shape[:-2]
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.empty(batch + (6,), **f32)
    P = torch.empty(batch + (6, 6), **f32)
    W = torch.empty(batch + (6, 6), **f32)
    iters = torch.empty(batch, dtype=torch.int32, device=dev)
    resid = torch.empty(batch, **f32)
    cond = torch.empty(batch, **f32)
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().dcreg_pcg6(
        *(v.data_ptr() for v in views), c_strides, len(strides),
        x.data_ptr(), P.data_ptr(), W.data_ptr(), iters.data_ptr(),
        resid.data_ptr(), cond.data_ptr(), nb, int(thresholds.pcg_max_iter),
        float(thresholds.pcg_tolerance), float(thresholds.kappa_target),
        stream)
    if rc != 0:
        raise RuntimeError(f"pcg6 kernel launch failed: cudaError {rc}")
    graphs.note_launch(solve_pcg_fast)
    return x, SolveInfo(P_preconditioner=P, W_adaptive=W,
                        pcg_iterations=iters, pcg_residual=resid,
                        cond_PH=cond)


def solve_pcg_fast(H, g, analysis: DegeneracyAnalysis,
                   thresholds: DegeneracyThresholds):
    """PRECONDITIONED_CG for the in-loop fast path (the boundary of
    pcg6): CPU tensors take the plain twin ``solve_pcg_fast_plain``; CUDA
    tensors launch the kernel, float32 as the port runs on the card (or
    raise)."""
    if H.device.type == "cpu":
        return solve_pcg_fast_plain(H, g, analysis, thresholds)
    return _launch_cuda(H, g, analysis, thresholds)


solve_pcg_fast.launches = 0
solve_pcg_fast.launches_replayed = 0  # those of them made by graph replays


def _solve_static(H, g, method: HandlingMethod,
                  analysis: DegeneracyAnalysis,
                  thresholds: DegeneracyThresholds, telemetry: bool):
    eye = _eye6_like(H)
    zero6 = torch.zeros_like(H)
    info = SolveInfo(P_preconditioner=eye, W_adaptive=zero6,
                     pcg_iterations=_no_iters(g), pcg_residual=_nan_like(g),
                     cond_PH=_nan_like(g))
    if method is HandlingMethod.NONE:
        return solve_none(analysis, g), info
    if method is HandlingMethod.SOLUTION_REMAPPING:
        return solve_solution_remapping(analysis, g), info
    if method is HandlingMethod.TRUNCATED_SVD:
        return solve_truncated_svd(analysis, g), info
    if method is HandlingMethod.STANDARD_REGULARIZATION:
        return solve_standard_regularization(
            analysis, g, thresholds.std_reg_gamma), info
    P = targeted_preconditioner(analysis, thresholds.kappa_target)
    if method is HandlingMethod.ADAPTIVE_REGULARIZATION:
        W = adaptive_regularizer(analysis, thresholds.adaptive_reg_alpha)
        W = torch.where(analysis.is_degenerate[..., None, None], W,
                        torch.zeros_like(W))
        x, _, _ = pcg_unrolled(H + W, g, P, 2 * thresholds.pcg_max_iter,
                               thresholds.pcg_tolerance)
        return x, info._replace(W_adaptive=W)
    if method is not HandlingMethod.PRECONDITIONED_CG:
        # engine-level methods (XICP_*, SUPERLOC, O3D) take the plain solve
        return solve_none(analysis, g), info
    x_raw, pcg_iters, pcg_resid = pcg_unrolled(
        H, g, P, thresholds.pcg_max_iter, thresholds.pcg_tolerance)
    use_pcg = analysis.is_degenerate
    x = torch.where(use_pcg[..., None], x_raw, solve_none(analysis, g))
    if telemetry:
        sqrtP = _schur_sqrt_precond(analysis, thresholds.kappa_target)
        wm, _ = linalg.symmetric_eigh(sqrtP @ H @ sqrtP)
        cond_PH = linalg.condition_number(wm)
    else:
        cond_PH = _nan_like(g)
    return x, SolveInfo(
        P_preconditioner=P, W_adaptive=zero6,
        pcg_iterations=torch.where(use_pcg, pcg_iters, _no_iters(g)),
        pcg_residual=torch.where(use_pcg, pcg_resid, _nan_like(g)),
        cond_PH=cond_PH)


def solve(H, g, method: HandlingMethod, analysis: DegeneracyAnalysis,
          thresholds: DegeneracyThresholds = DegeneracyThresholds(),
          telemetry: bool = True, fast: bool = False):
    """Dispatch on a static HandlingMethod.  Returns (dx, SolveInfo).
    ``telemetry=False`` skips the cond(PH) eigendecomposition."""
    if fast and method is HandlingMethod.PRECONDITIONED_CG:
        return solve_pcg_fast(H, g, analysis, thresholds)
    return _solve_static(H, g, method, analysis, thresholds, telemetry)
