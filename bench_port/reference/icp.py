"""Plain reference of one registration of the localization loop, in
PyTorch, written from the method's description and importing nothing of
the system under test.

One registration: the constant-velocity seed (or a given initial pose),
then Gauss-Newton steps, each of

  * the neighbour search: the exact k nearest map points of every
    transformed scan point (brute force over the map's points near the
    scan), kept when the k-th lies within the search radius;
  * the point-to-plane system: the plane n.p + d = 0 through the k
    neighbours as the least squares of A x = -1, a thickness gate, the
    residual r = n.p + d with the robust weight s = max(0, 1 - slope |r|)
    and, with the weight derivative, row scale s + r ds/dr; rows
    J = [p x R^T n, R^T n], H = J^T J, g = J^T (-s r);
  * the degeneracy analysis: the Schur complements of H's rotation and
    translation blocks, their condition numbers and the mask of
    directions whose eigenvalue ratio passes the threshold; for the
    full-spectrum detection, H's eigenvalues against the eigenvalue
    threshold;
  * the step: for the Schur detection, preconditioned CG with the
    targeted preconditioner V diag(1 / max(lam, lam_max / kappa)) V^T per
    block where the system is degenerate, the plain solve elsewhere; for
    the full-spectrum detection, the truncated-SVD pseudo-inverse whose
    mask (ascending eigenvalue order) indexes the descending singular
    values;
  * the pose update R exp(w), t + R v, and convergence when |w| and |v|
    fall under their thresholds.

``precision`` is "float64" (the reference), "float32", or "tf32": float32
with the operands of every matrix product rounded to TF32's 10-bit
mantissa, as the tensor cores round them (the control).
"""
from __future__ import annotations

import math

import torch

SEARCH_SLACK_M = 2.0       # the map is cropped once per registration


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


class Numerics:
    """The dtype of a run and how its matrix products round."""

    def __init__(self, precision: str):
        if precision not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float64 if precision == "float64" \
            else torch.float32

    def einsum(self, eq, *ops):
        if self.tf32:
            ops = [tf32_round(o) for o in ops]
        return torch.einsum(eq, *ops)


def exp_so3(w):
    th = torch.linalg.norm(w)
    K = torch.zeros(3, 3, dtype=w.dtype, device=w.device)
    K[0, 1], K[0, 2], K[1, 2] = -w[2], w[1], -w[0]
    K[1, 0], K[2, 0], K[2, 1] = w[2], -w[1], w[0]
    if float(th) < 1e-8:
        a, b = 1.0 - float(th) ** 2 / 6.0, 0.5
    else:
        a = math.sin(float(th)) / float(th)
        b = (1.0 - math.cos(float(th))) / float(th) ** 2
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def orthonormalize(R):
    r0 = R[0] / torch.linalg.norm(R[0])
    r1 = R[1] - torch.dot(r0, R[1]) * r0
    r1 = r1 / torch.linalg.norm(r1)
    return torch.stack([r0, r1, torch.linalg.cross(r0, r1)])


def cv_seed(T1, T2):
    """The constant-velocity seed T1 (T2^-1 T1), projected onto SO(3)."""
    R1, t1, R2, t2 = T1[:3, :3], T1[:3, 3], T2[:3, :3], T2[:3, 3]
    dR = R2.T @ R1
    dt = R2.T @ (t1 - t2)
    return orthonormalize(R1 @ dR), R1 @ dt + t1


def knn(p, cand, k):
    """Exact k nearest of each row of ``p`` among ``cand``: (squared
    distances ascending, indices), coordinate-wise distances."""
    chunk = max(1, (1 << 25) // max(1, cand.shape[0]))
    vals, idx = [], []
    for s in range(0, p.shape[0], chunk):
        q = p[s:s + chunk]
        d = (q[:, None, 0] - cand[None, :, 0]) ** 2
        d += (q[:, None, 1] - cand[None, :, 1]) ** 2
        d += (q[:, None, 2] - cand[None, :, 2]) ** 2
        v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def crop(world, lo, hi):
    return world[((world >= lo) & (world <= hi)).all(1)]


def point_to_plane(num, src, cand, R, t, corr, weight_derivative):
    """(H, g, n_valid, the sum of the rows' squared scales, the RMS
    residual of the valid points) of the scan ``src`` at pose (R, t)
    against the map points ``cand``."""
    k, radius = corr["k"], corr["search_radius"]
    p = num.einsum("nj,ij->ni", src, R) + t
    sq, idx = knn(p, cand, k)
    in_radius = sq[:, k - 1] < radius ** 2
    nb = cand[idx]                                        # (N, k, 3)
    c = nb.mean(1)
    C = nb - c[:, None]
    S = num.einsum("nki,nkj->nij", C, C)
    # x = argmin |A x + 1|^2 by Sherman-Morrison on A^T A = S + k c c^T
    w, info = torch.linalg.solve_ex(S, c[..., None])
    w = w[..., 0]
    x = -k * w / (1.0 + k * (c * w).sum(1))[:, None]
    xx = (x * x).sum(1)
    fit_ok = (info == 0) & torch.isfinite(xx) & (xx >= 1e-12)
    inv = torch.rsqrt(torch.where(fit_ok, xx, torch.ones_like(xx)))
    n, d = x * inv[:, None], inv
    dev = (nb * n[:, None]).sum(2) + d[:, None]
    plane_ok = (dev * dev).amax(1) < corr["max_plane_thickness"] ** 2
    r = (p * n).sum(1) + d
    slope = corr["weight_slope"]
    s = torch.clamp(1.0 - slope * r.abs(), min=0.0)
    valid = in_radius & fit_ok & plane_ok & (s > corr["min_weight"])
    s = torch.where(valid, s, torch.zeros_like(s))
    scale = s
    if weight_derivative:
        ramp = (s > 0) & (s < 1)
        scale = s + r * torch.where(ramp, -slope * torch.sign(r),
                                    torch.zeros_like(r))
    scale = torch.where(valid, scale, torch.zeros_like(scale))
    nR = num.einsum("ni,ij->nj", n, R)
    J = torch.cat([torch.linalg.cross(src, nR, dim=1), nR], 1) \
        * scale[:, None]
    b = torch.where(valid, -s * r, torch.zeros_like(r))
    H = num.einsum("ni,nj->ij", J, J)
    g = num.einsum("ni,n->i", J, b)
    n_valid = int(valid.sum())
    rmse = math.sqrt(float(torch.where(valid, r * r, 0.0 * r).sum())
                     / max(n_valid, 1))
    return H, g, n_valid, float((scale * scale).sum()), rmse


def schur_analysis(H, th):
    """Schur-complement condition numbers, degeneracy flag and mask (rot
    then trans, each in ascending eigenvalue order)."""
    A, Bm, Cm, D = H[:3, :3], H[:3, 3:], H[3:, :3], H[3:, 3:]
    det_rr, det_tt = torch.linalg.det(A), torch.linalg.det(D)
    ok = bool(det_tt.abs() > 1e-10 * (D.abs().max() ** 3 + 1e-12)) and \
        bool(det_rr.abs() > 1e-10 * (A.abs().max() ** 3 + 1e-12))
    sv = torch.linalg.eigvalsh(0.5 * (H + H.T)).abs().sort(descending=True)[0]
    out = {"schur_valid": ok,
           "cond_full": float(sv[0] / sv[5]) if float(sv[5]) > 1e-12
           else math.inf}
    if not ok:
        out.update(cond_rot=math.inf, cond_trans=math.inf, degenerate=True,
                   mask=[False] * 6)
        return out
    S_R = A - Bm @ torch.linalg.inv(D) @ Cm
    S_t = D - Cm @ torch.linalg.inv(A) @ Bm
    wr, Vr = torch.linalg.eigh(0.5 * (S_R + S_R.T))
    wt, Vt = torch.linalg.eigh(0.5 * (S_t + S_t.T))
    cond = lambda w: float(w[2] / torch.clamp(w[0], min=1e-12))
    ct = th["cond_thresh"]
    c_r, c_t = cond(wr), cond(wt)
    rot_bad, trans_bad = c_r > ct, c_t > ct
    ratio = lambda w: (w[2] / torch.clamp(w, min=1e-12) > ct).tolist()
    out.update(cond_rot=c_r, cond_trans=c_t, degenerate=rot_bad or trans_bad,
               mask=[rot_bad and m for m in ratio(wr)]
               + [trans_bad and m for m in ratio(wt)],
               lam_rot=wr, V_rot=Vr, lam_trans=wt, V_trans=Vt)
    return out


def pcg(H, g, P, max_iter, tol):
    x = torch.zeros_like(g)
    r = g.clone()
    z = P @ r
    p = z.clone()
    rz = torch.dot(r, z)
    thresh = tol * max(float(torch.linalg.norm(g)), 1e-30)
    for _ in range(max_iter):
        Hp = H @ p
        pHp = torch.dot(p, Hp)
        if abs(float(pHp)) <= 1e-30:
            break
        alpha = rz / pHp
        x = x + alpha * p
        r = r - alpha * Hp
        z = P @ r
        rz_new = torch.dot(r, z)
        beta = rz_new / rz if abs(float(rz)) > 1e-30 else 0.0 * rz_new
        p = z + beta * p
        rz = rz_new
        if float(torch.linalg.norm(r)) <= thresh:
            break
    return x


def targeted_preconditioner(ana, kappa):
    def block(lam, V):
        lam_c = torch.maximum(lam, lam[2] / kappa)
        return (V / lam_c) @ V.T

    P = torch.zeros(6, 6, dtype=ana["lam_rot"].dtype,
                    device=ana["lam_rot"].device)
    P[:3, :3] = block(ana["lam_rot"], ana["V_rot"])
    P[3:, 3:] = block(ana["lam_trans"], ana["V_trans"])
    if not bool(torch.isfinite(P).all()):
        return torch.eye(6, dtype=P.dtype, device=P.device)
    return P


def step(H, g, method, th):
    """(dx, analysis) of one Gauss-Newton step under ``method``."""
    detection, handling = method
    if detection == "SCHUR_CONDITION_NUMBER" and \
            handling == "PRECONDITIONED_CG":
        ana = schur_analysis(H, th)
        if ana["degenerate"] and ana["schur_valid"]:
            P = targeted_preconditioner(ana, th["kappa_target"])
            return pcg(H, g, P, th["pcg_max_iter"], th["pcg_tolerance"]), ana
        if ana["degenerate"]:
            return pcg(H, g, torch.eye(6, dtype=H.dtype, device=H.device),
                       th["pcg_max_iter"], th["pcg_tolerance"]), ana
        return torch.linalg.solve(H, g), ana
    if detection == "FULL_EVD_MIN_EIGENVALUE" and \
            handling == "TRUNCATED_SVD":
        ana = schur_analysis(H, th)
        w, V = torch.linalg.eigh(0.5 * (H + H.T))
        mask = w < th["eig_thresh"]
        sv, U = torch.flip(w.abs(), (0,)), torch.flip(V, (1,))
        ana["degenerate"] = bool(mask.any())
        ana["mask"] = mask.tolist()
        keep = (sv > 1e-9) & ~mask
        if not bool(keep.any()):
            return torch.zeros_like(g), ana
        inv = torch.where(keep, 1.0 / torch.where(keep, sv,
                                                  torch.ones_like(sv)),
                          torch.zeros_like(sv))
        return U @ (inv * (U.T @ g)), ana
    raise ValueError(f"the reference has no method {method}")


def register(src, world, seed_pose, method, icp, precision="float64",
             steps_at_least=0):
    """One registration of the (N, 3) body-frame scan ``src`` against the
    (M, 3) map ``world``.  ``seed_pose`` is ("cv", T1, T2), the two poses
    before the frame, or ("pose", R0, t0).  Runs its own steps to
    convergence (or ``icp["max_iterations"]``) and on, without moving its
    convergence step, to ``steps_at_least`` steps.

    Returns {"R": [...], "t": [...]} (index i: after i steps; 0 the seed),
    "ana": [...] (index i >= 1: the analysis of step i's H, taken at pose
    i - 1), "H": [...], "w2": [...] and "rmse": [...] (step i's system,
    the sum of its rows' squared scales and its RMS residual), "steps":
    the steps to its own stop."""
    num = Numerics(precision)
    dt, dev = num.dtype, world.device
    f = lambda x: torch.as_tensor(x, device=dev).to(dt)
    if seed_pose[0] == "cv":
        R, t = cv_seed(f(seed_pose[1]), f(seed_pose[2]))
    else:
        R, t = f(seed_pose[1]), f(seed_pose[2])
    src, world = f(src), world
    corr, th = icp["corr"], icp["thresholds"]
    reach = corr["search_radius"] + SEARCH_SLACK_M
    p0 = src @ R.T + t
    box_lo, box_hi = p0.amin(0) - reach, p0.amax(0) + reach
    cand = f(crop(world, box_lo.float(), box_hi.float()))
    out = {"R": [R], "t": [t], "ana": [None], "H": [None], "w2": [None],
           "rmse": [None], "steps": None}
    limit = icp["max_iterations"]
    for it in range(limit):
        if out["steps"] is not None and it >= steps_at_least:
            break
        p = src @ R.T + t
        if bool((p.amin(0) - corr["search_radius"] < box_lo).any()) or \
                bool((p.amax(0) + corr["search_radius"] > box_hi).any()):
            raise RuntimeError("the pose left the reference's map crop")
        H, g, n_valid, w2, rmse = point_to_plane(
            num, src, cand, R, t, corr, icp["use_weight_derivative"])
        dx, ana = step(H, g, method, th)
        abort = n_valid < icp["min_effective_points"] or \
            not bool(torch.isfinite(dx).all())
        if not abort:
            R, t = R @ exp_so3(dx[:3]), t + R @ dx[3:]
        conv = float(torch.linalg.norm(dx[:3])) < \
            icp["convergence_thresh_rot"] and \
            float(torch.linalg.norm(dx[3:])) < icp["convergence_thresh_trans"]
        out["R"].append(R)
        out["t"].append(t)
        out["ana"].append(ana)
        out["H"].append(H)
        out["w2"].append(w2)
        out["rmse"].append(rmse)
        if out["steps"] is None and (conv or abort):
            out["steps"] = it + 1
    if out["steps"] is None:
        out["steps"] = limit
    return out
