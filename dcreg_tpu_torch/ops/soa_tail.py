"""Structure-of-arrays correspondence tail + GN assembly for batched lanes
(counterpart of ``dcreg_tpu/ops/soa_tail.py``).

Plane fit ``A x = -1`` in closed form with rank handling, thickness gate,
robust weight and SO(3) right-perturbation GN rows, on component arrays
shaped (B, N) / (B, k, N) with the point axis minor.  The two reductions
to H and g are f32 einsums, which stay full f32 because the port keeps
TF32 off (``dcreg_tpu_torch.utils.precise``).

The plane fit, ``_plane_fit``, is a kernel boundary (``PLANE_FIT``, a
``cuda_build.Kernel``): a CUDA tensor launches the hand-written kernel
plane_fit (``csrc/plane_fit.cu``, built on first use with nvcc and bound
with ctypes; one launch where the plain form runs 444 small ops), a CPU
tensor takes the plain PyTorch twin ``_plane_fit_plain``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build, graphs
from .correspondence import CorrespondenceParams
from .gauss_newton import GNSystem


def _eigh3_soa(sxx, sxy, sxz, syy, syz, szz):
    """Closed-form symmetric 3x3 EVD on component arrays (any shape).
    Returns (lam: 3-tuple ascending, V: 3-tuple of 3-component columns)."""
    dt, dev = sxx.dtype, sxx.device
    one = torch.ones((), dtype=dt, device=dev)
    q = (sxx + syy + szz) / 3.0
    b00, b11, b22 = sxx - q, syy - q, szz - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (sxy * sxy + sxz * sxz + syz * syz)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    tiny = p <= 1e-30
    p_safe = torch.where(tiny, one, p)
    detB = (b00 * (b11 * b22 - syz * syz)
            - sxy * (sxy * b22 - syz * sxz)
            + sxz * (sxy * syz - b11 * sxz))
    r = torch.clamp(detB / (2.0 * p_safe * p_safe * p_safe), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w2 = q + 2.0 * p * torch.cos(phi)
    w0 = q + 2.0 * p * torch.cos(phi + 2.0943951023931953)
    w1 = 3.0 * q - w2 - w0
    w0 = torch.where(tiny, q, w0)
    w1 = torch.where(tiny, q, w1)
    w2 = torch.where(tiny, q, w2)

    def null_vector(lam):
        r0x, r0y, r0z = sxx - lam, sxy, sxz
        r1x, r1y, r1z = sxy, syy - lam, syz
        r2x, r2y, r2z = sxz, syz, szz - lam
        c01x = r0y * r1z - r0z * r1y
        c01y = r0z * r1x - r0x * r1z
        c01z = r0x * r1y - r0y * r1x
        c02x = r0y * r2z - r0z * r2y
        c02y = r0z * r2x - r0x * r2z
        c02z = r0x * r2y - r0y * r2x
        c12x = r1y * r2z - r1z * r2y
        c12y = r1z * r2x - r1x * r2z
        c12z = r1x * r2y - r1y * r2x
        n01 = c01x * c01x + c01y * c01y + c01z * c01z
        n02 = c02x * c02x + c02y * c02y + c02z * c02z
        n12 = c12x * c12x + c12y * c12y + c12z * c12z
        use01 = (n01 >= n02) & (n01 >= n12)
        use02 = ~use01 & (n02 >= n12)
        cx = torch.where(use01, c01x, torch.where(use02, c02x, c12x))
        cy = torch.where(use01, c01y, torch.where(use02, c02y, c12y))
        cz = torch.where(use01, c01z, torch.where(use02, c02z, c12z))
        n2 = cx * cx + cy * cy + cz * cz
        ok = n2 > 1e-60
        inv = 1.0 / torch.sqrt(torch.where(ok, n2, one))
        return cx * inv, cy * inv, cz * inv, ok

    hi_first = (w2 - w1) >= (w1 - w0)
    lam_a = torch.where(hi_first, w2, w0)
    lam_b = torch.where(hi_first, w0, w2)
    ax, ay, az, ok_a = null_vector(lam_a)
    bx, by, bz, ok_b = null_vector(lam_b)
    ax = torch.where(ok_a, ax, one)
    ay = torch.where(ok_a, ay, 0.0)
    az = torch.where(ok_a, az, 0.0)
    aax, aay, aaz = torch.abs(ax), torch.abs(ay), torch.abs(az)
    x_least = (aax <= aay) & (aax <= aaz)
    y_least = ~x_least & (aay <= aaz)
    fx = x_least.to(dt)
    fy = y_least.to(dt)
    fz = 1.0 - fx - fy
    bx = torch.where(ok_b, bx, fx)
    by = torch.where(ok_b, by, fy)
    bz = torch.where(ok_b, bz, fz)
    dot = bx * ax + by * ay + bz * az
    bx, by, bz = bx - dot * ax, by - dot * ay, bz - dot * az
    nb2 = bx * bx + by * by + bz * bz
    ok_nb = nb2 > 1e-60
    invb = 1.0 / torch.sqrt(torch.where(ok_nb, nb2, one))
    gx = ay * fz - az * fy
    gy = az * fx - ax * fz
    gz = ax * fy - ay * fx
    g2 = torch.sqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-60))
    bx = torch.where(ok_nb, bx * invb, gx / g2)
    by = torch.where(ok_nb, by * invb, gy / g2)
    bz = torch.where(ok_nb, bz * invb, gz / g2)
    cx = ay * bz - az * by
    cy = az * bx - ax * bz
    cz = ax * by - ay * bx
    v0 = (torch.where(hi_first, bx, ax), torch.where(hi_first, by, ay),
          torch.where(hi_first, bz, az))
    v2 = (torch.where(hi_first, ax, bx), torch.where(hi_first, ay, by),
          torch.where(hi_first, az, bz))
    return (w0, w1, w2), (v0, (cx, cy, cz), v2)


def batched_tail_system(source_xyz, target_xyz, Rs, ts, sq_d5, idx_kn,
                        params: CorrespondenceParams,
                        use_weight_derivative: bool = True,
                        weight_slope: float = 0.9) -> GNSystem:
    """Fused correspondence tail + GN assembly for all lanes.

    source_xyz (N, 3), or (B, N, 3) where each lane registers a source of
    its own; target_xyz (M, 3); Rs (B, 3, 3); ts (B, 3);
    sq_d5 (B, N) squared k-th neighbour distance (the radius gate);
    idx_kn (B, k, N) neighbour indices, -1 where missing.  Returns a
    GNSystem with leading (B,) dims.  Its two modules are marked
    (``graphs.mark``): ``tail.planes`` and ``tail.system``."""
    with graphs.mark("tail.planes"):
        plane = _plane_fit(target_xyz, idx_kn, params)
    with graphs.mark("tail.system"):
        return _gn_system(source_xyz, Rs, ts, sq_d5, *plane, params,
                          use_weight_derivative, weight_slope)


def _plane_fit_plain(target_xyz, idx_kn, params: CorrespondenceParams):
    """Plain PyTorch twin of plane_fit, the neighbours' plane fit: (unit
    normal components nox, noy, noz, offset d_off, fit_ok, plane_ok), each
    (B, N)."""
    dt, dev = target_xyz.dtype, target_xyz.device
    one = torch.ones((), dtype=dt, device=dev)
    k = idx_kn.shape[1]
    fk = float(k)

    neigh = target_xyz[torch.clamp(idx_kn, min=0)]        # (B, k, N, 3)
    nx_, ny_, nz_ = neigh[..., 0], neigh[..., 1], neigh[..., 2]

    cx = torch.mean(nx_, dim=1)
    cy = torch.mean(ny_, dim=1)
    cz = torch.mean(nz_, dim=1)
    dx_ = nx_ - cx[:, None]
    dy_ = ny_ - cy[:, None]
    dz_ = nz_ - cz[:, None]
    sxx = torch.sum(dx_ * dx_, dim=1)
    sxy = torch.sum(dx_ * dy_, dim=1)
    sxz = torch.sum(dx_ * dz_, dim=1)
    syy = torch.sum(dy_ * dy_, dim=1)
    syz = torch.sum(dy_ * dz_, dim=1)
    szz = torch.sum(dz_ * dz_, dim=1)
    lam, V = _eigh3_soa(sxx, sxy, sxz, syy, syz, szz)
    lam = tuple(torch.clamp(w, min=0.0) for w in lam)

    # rank-aware solve of (S + k c c^T) x = -k c in the eigenbasis
    a = tuple(vx * cx + vy * cy + vz * cz for (vx, vy, vz) in V)
    s_dir = tuple(lam[i] + fk * a[i] * a[i] for i in range(3))
    s_max = torch.maximum(torch.maximum(s_dir[0], s_dir[1]), s_dir[2])
    eps_rank = 100.0 * torch.finfo(dt).eps
    active = tuple(s_dir[i] > eps_rank * s_max for i in range(3))
    big = float("inf")
    mu = torch.minimum(
        torch.minimum(torch.where(active[0], lam[0], big),
                      torch.where(active[1], lam[1], big)),
        torch.where(active[2], lam[2], big))
    mu = torch.where(torch.isfinite(mu), mu, 0.0)
    r = []
    for i in range(3):
        lam_ok = lam[i] > 1e-30
        ri = torch.where(lam_ok, mu / torch.where(lam_ok, lam[i], one), one)
        r.append(torch.where(active[i], ri, 0.0))
    numx = -(a[0] * r[0] * V[0][0] + a[1] * r[1] * V[1][0]
             + a[2] * r[2] * V[2][0])
    numy = -(a[0] * r[0] * V[0][1] + a[1] * r[1] * V[1][1]
             + a[2] * r[2] * V[2][1])
    numz = -(a[0] * r[0] * V[0][2] + a[1] * r[1] * V[1][2]
             + a[2] * r[2] * V[2][2])
    den = mu / fk + a[0] * a[0] * r[0] + a[1] * a[1] * r[1] \
        + a[2] * a[2] * r[2]
    ok_den = torch.abs(den) > 1e-30
    inv_den = 1.0 / torch.where(ok_den, den, one)
    xx = numx * inv_den
    xy = numy * inv_den
    xz = numz * inv_den
    ps_sq = xx * xx + xy * xy + xz * xz
    fit_ok = ok_den & (ps_sq >= 1e-12)
    inv_ps = 1.0 / torch.sqrt(torch.where(fit_ok, ps_sq, one))
    nox = xx * inv_ps
    noy = xy * inv_ps
    noz = xz * inv_ps
    d_off = inv_ps

    pd = (nx_ * nox[:, None] + ny_ * noy[:, None] + nz_ * noz[:, None]
          + d_off[:, None])
    plane_ok = torch.amax(pd * pd, dim=1) < params.max_plane_thickness ** 2
    return nox, noy, noz, d_off, fit_ok, plane_ok


# ---------------------------------------------------------------------------
# plane_fit: the launch
# ---------------------------------------------------------------------------

# the kernel's cap on k, its K_MAX: the neighbours live in registers
K_MAX = 16


def kernel_operands(target_xyz, idx_kn):
    """(B, k, N, strides): the kernel's sizes and the element strides of
    its two operands, target_xyz (M, 3) and idx_kn (B, k, N), in its order.
    The kernel reads the caller's tensors in place, the loop's view
    ``idx[:, :k, :N]`` included, so no copy runs.  Raises where a shape
    does not fit or k is above the kernel's cap."""
    if target_xyz.ndim != 2 or target_xyz.shape[1] != 3:
        raise ValueError(f"plane_fit: target_xyz has shape "
                         f"{tuple(target_xyz.shape)}, expected (M, 3)")
    if idx_kn.ndim != 3:
        raise ValueError(f"plane_fit: idx_kn has shape "
                         f"{tuple(idx_kn.shape)}, expected (B, k, N)")
    B, k, N = idx_kn.shape
    if not 1 <= k <= K_MAX:
        raise ValueError(f"plane_fit: k = {k} is outside the kernel's "
                         f"range 1..{K_MAX}")
    return B, k, N, [*target_xyz.stride(), *idx_kn.stride()]


def _launch(target_xyz, idx_kn, params: CorrespondenceParams):
    B, k, N, strides = kernel_operands(target_xyz, idx_kn)
    for name, t, want in (("target_xyz", target_xyz, torch.float32),
                          ("idx_kn", idx_kn, torch.int32)):
        if t.dtype != want:
            raise TypeError(f"plane_fit: {name} is {t.dtype}, expected "
                            f"{want}")
    dev = target_xyz.device
    if dev.type != "cuda" or idx_kn.device != dev:
        raise ValueError(f"plane_fit runs on a CUDA device, got "
                         f"{target_xyz.device} and {idx_kn.device}")
    f32 = dict(dtype=torch.float32, device=dev)
    nox, noy, noz, d_off = (torch.empty((B, N), **f32) for _ in range(4))
    fit_ok, plane_ok = (torch.empty((B, N), dtype=torch.bool, device=dev)
                        for _ in range(2))
    # ATen's mean scales its sum by float(outputs) / float(inputs), and its
    # division by a host scalar multiplies by the float reciprocal
    mean_factor = float(np.float32(B * N) / np.float32(B * k * N)) \
        if B * N else 0.0
    inv_k = float(np.float32(1.0) / np.float32(k))
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    PLANE_FIT.launch(
        target_xyz.data_ptr(), idx_kn.data_ptr(), c_strides, len(strides),
        nox.data_ptr(), noy.data_ptr(), noz.data_ptr(), d_off.data_ptr(),
        fit_ok.data_ptr(), plane_ok.data_ptr(), B, k, N, mean_factor, inv_k,
        params.max_plane_thickness ** 2, device=dev)
    return nox, noy, noz, d_off, fit_ok, plane_ok


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PLANE_FIT = cuda_build.Kernel(
    "plane_fit", "plane_fit.cu", "dcreg_plane_fit",
    [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P],
    twin=_plane_fit_plain, on_card=_launch)


def _plane_fit(target_xyz, idx_kn, params: CorrespondenceParams):
    """The neighbours' plane fit (the boundary of plane_fit): CPU tensors
    take the plain twin ``_plane_fit_plain``; CUDA tensors launch the
    kernel, float32 target and int32 ids as the loop hands them (or
    raise).  Returns (nox, noy, noz, d_off, fit_ok, plane_ok), each
    (B, N)."""
    return PLANE_FIT(target_xyz, idx_kn, params)


def _gn_system(source_xyz, Rs, ts, sq_d5, nox, noy, noz, d_off, fit_ok,
               plane_ok, params: CorrespondenceParams,
               use_weight_derivative: bool, weight_slope: float) -> GNSystem:
    """Residuals, robust weights and the GN rows at (Rs, ts) against the
    fitted planes, reduced to H and g."""
    dt = source_xyz.dtype
    N = source_xyz.shape[-2]
    per_lane = source_xyz.ndim == 3
    p_w = torch.einsum('bnj,bij->bni' if per_lane else 'nj,bij->bni',
                       source_xyz, Rs) + ts[:, None, :]
    pwx, pwy, pwz = p_w[..., 0], p_w[..., 1], p_w[..., 2]

    residual = pwx * nox + pwy * noy + pwz * noz + d_off
    s = torch.clamp(1.0 - params.weight_slope * torch.abs(residual), min=0.0)
    weight_ok = s > params.min_weight
    in_radius = sq_d5 < params.search_radius ** 2
    valid = in_radius & fit_ok & plane_ok & weight_ok
    s = torch.where(valid, s, 0.0)

    if use_weight_derivative:
        on_ramp = (s > 0.0) & (s < 1.0)
        ds_dr = torch.where(on_ramp, -weight_slope * torch.sign(residual),
                            0.0)
        row_scale = s + residual * ds_dr
    else:
        row_scale = s
    row_scale = torch.where(valid, row_scale, 0.0)

    R = Rs
    nRx = nox * R[:, 0, 0, None] + noy * R[:, 1, 0, None] \
        + noz * R[:, 2, 0, None]
    nRy = nox * R[:, 0, 1, None] + noy * R[:, 1, 1, None] \
        + noz * R[:, 2, 1, None]
    nRz = nox * R[:, 0, 2, None] + noy * R[:, 1, 2, None] \
        + noz * R[:, 2, 2, None]
    px, py, pz = source_xyz[..., 0], source_xyz[..., 1], source_xyz[..., 2]
    if not per_lane:
        px, py, pz = px[None], py[None], pz[None]
    J0 = py * nRz - pz * nRy
    J1 = pz * nRx - px * nRz
    J2 = px * nRy - py * nRx
    Js = torch.stack([J0, J1, J2, nRx, nRy, nRz], dim=1)   # (B, 6, N)
    Js = Js * row_scale[:, None, :]
    b = -(s * residual)

    H = torch.einsum('bin,bjn->bij', Js, Js)
    g = torch.einsum('bin,bn->bi', Js, b)

    n_valid = torch.sum(valid.to(torch.int32), dim=1)
    raw_sq = torch.where(valid, residual * residual, 0.0)
    rmse = torch.sqrt(torch.sum(raw_sq, dim=1)
                      / torch.clamp(n_valid, min=1).to(dt))
    fitness = torch.sum(in_radius.to(dt), dim=1) / float(N)
    objective = 0.5 * torch.sum(b * b, dim=1)
    return GNSystem(H=H, g=g, num_valid=n_valid, rmse=rmse,
                    fitness=fitness, objective=objective)
