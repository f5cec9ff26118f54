"""Small dense linear algebra for the 6x6 / 3x3 spectral path
(counterpart of ``dcreg_tpu/ops/linalg.py``).

The same fixed-sweep tournament Jacobi eigensolver, closed-form 3x3
eigensolver, adjugate 3x3 inverse and unrolled 6x6 Cholesky as the JAX
module, batched over leading dimensions.  Keeping the JAX algorithms
(rather than ``torch.linalg.eigh``) keeps eigenvector signs, ordering and
the PCG iteration counts that depend on them identical to the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_SWEEPS = {3: 6, 6: 8}

_SCHEDULES = {
    3: [[(0, 1)], [(0, 2)], [(1, 2)]],
    6: [
        [(0, 5), (1, 4), (2, 3)],
        [(0, 4), (3, 5), (1, 2)],
        [(0, 3), (2, 4), (1, 5)],
        [(0, 2), (1, 3), (4, 5)],
        [(0, 1), (2, 5), (3, 4)],
    ],
}


@functools.lru_cache(maxsize=None)
def _round_constants(n: int, pairs, dtype, device):
    """Basis matrices for one tournament round: G is
    eye_rest + sum(c * D + s * S) over the round's disjoint pairs.  Cached
    per dtype and device, so a round copies nothing to the card (each
    host-to-device copy would synchronise the stream)."""
    eye_rest = np.eye(n)
    diag_basis, skew_basis = [], []
    for (p, q) in pairs:
        eye_rest[p, p] = eye_rest[q, q] = 0.0
        D = np.zeros((n, n)); D[p, p] = D[q, q] = 1.0
        S = np.zeros((n, n)); S[p, q] = 1.0; S[q, p] = -1.0
        diag_basis.append(D)
        skew_basis.append(S)
    annihilate = np.ones((n, n))
    for (p, q) in pairs:
        annihilate[p, q] = annihilate[q, p] = 0.0
    as_t = functools.partial(torch.as_tensor, dtype=dtype, device=device)
    return (as_t(eye_rest), tuple(map(as_t, diag_basis)),
            tuple(map(as_t, skew_basis)), as_t(annihilate))


def _round_rotation(A, V, pairs):
    """One tournament round of Jacobi rotations as a composite orthogonal
    transform."""
    n = A.shape[-1]
    eye_rest, diag_basis, skew_basis, annihilate = _round_constants(
        n, tuple(pairs), A.dtype, A.device)
    G = eye_rest.expand(A.shape)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    for (p, q), D, S in zip(pairs, diag_basis, skew_basis):
        app = A[..., p, p]
        aqq = A[..., q, q]
        apq = A[..., p, q]
        nonzero = torch.abs(apq) > 0.0
        tau = torch.where(nonzero,
                          (aqq - app) / torch.where(nonzero, 2.0 * apq, one),
                          0.0)
        t = torch.sign(tau) / (torch.abs(tau)
                               + torch.hypot(torch.ones_like(tau), tau))
        t = torch.where(tau == 0.0, one, t)
        t = torch.where(nonzero, t, 0.0)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        G = G + c[..., None, None] * D + s[..., None, None] * S
    A_new = G.transpose(-1, -2) @ A @ G
    A_new = A_new * annihilate
    return A_new, V @ G


def symmetric_eigh(A, sweeps: int | None = None):
    """Eigendecomposition of symmetric (..., n, n) matrices by tournament
    cyclic Jacobi.  Returns (eigenvalues ascending, eigenvectors as
    columns); ties in the sort keep the diagonal order (stable)."""
    n = A.shape[-1]
    if sweeps is None:
        sweeps = _SWEEPS.get(n, 10)
    schedule = _SCHEDULES.get(
        n, [[(p, q)] for p in range(n - 1) for q in range(p + 1, n)])
    A = 0.5 * (A + A.transpose(-1, -2))
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    for _ in range(sweeps):
        for pairs in schedule:
            A, V = _round_rotation(A, V, pairs)
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w_sorted = torch.gather(w, -1, order)
    V_sorted = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w_sorted, V_sorted


def psd_svd_from_eigh(w_asc, V):
    """Singular values (descending) and U = V columns of a symmetric PSD
    matrix from its ascending EVD."""
    return torch.flip(torch.abs(w_asc), dims=(-1,)), torch.flip(V, dims=(-1,))


def solve_qr_6x6(A, b):
    """Dense solve of the 6x6 system A x = b, batched.  Every system the
    engines solve this way is symmetric (GN Hessians, Tikhonov- or
    LM-damped), so it is the spectral solve x = V diag(1/w) V^T b of the
    JAX module, exact-arithmetic equal to the reference's
    colPivHouseholderQr; a near-singular A gives a large solution, as QR
    does."""
    w, V = symmetric_eigh(A)
    safe = torch.abs(w) > 1e-300
    inv_w = torch.where(safe, 1.0 / torch.where(safe, w, torch.ones_like(w)),
                        0.0)
    y = inv_w * (V.transpose(-1, -2) @ b[..., None])[..., 0]
    return (V @ y[..., None])[..., 0]


def inv_3x3(A):
    """Closed-form 3x3 inverse (adjugate / det), batched.  Returns
    (inverse, det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.stack([
        torch.stack([A11, A12, A13], dim=-1),
        torch.stack([A21, A22, A23], dim=-1),
        torch.stack([A31, A32, A33], dim=-1),
    ], dim=-2)
    return adj * (1.0 / det)[..., None, None], det


def solve_lstsq_normal(A, b, reg: float = 0.0):
    """Least squares of tall skinny systems (..., n, 3) through the normal
    equations: x = (A^T A + reg I)^-1 A^T b with the closed-form 3x3
    inverse.  Returns (x, det(A^T A + reg I))."""
    AtA = torch.einsum("...ij,...ik->...jk", A, A)
    if reg:
        AtA = AtA + reg * torch.eye(A.shape[-1], dtype=A.dtype,
                                    device=A.device)
    Atb = torch.einsum("...ij,...i->...j", A, b)
    inv, det = inv_3x3(AtA)
    return torch.einsum("...ij,...j->...i", inv, Atb), det


def eigh3_closed(A):
    """Closed-form eigendecomposition of symmetric 3x3 matrices (batched):
    trigonometric eigenvalues, eigenvectors from the largest cross product
    of rows of (A - lambda I).  Returns (ascending (..., 3), columns
    (..., 3, 3))."""
    dtype = A.dtype
    A = 0.5 * (A + A.transpose(-1, -2))
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    one = torch.ones((), dtype=dtype, device=A.device)

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    tiny = p <= 1e-30
    p_safe = torch.where(tiny, one, p)
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * p_safe * p_safe * p_safe), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    w2 = q + 2.0 * p * torch.cos(phi)
    w0 = q + 2.0 * p * torch.cos(phi + two_pi_3)
    w1 = 3.0 * q - w2 - w0
    w0 = torch.where(tiny, q, w0)
    w1 = torch.where(tiny, q, w1)
    w2 = torch.where(tiny, q, w2)

    def best_null_vector(lam):
        r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
        r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
        r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
        c01 = torch.linalg.cross(r0, r1, dim=-1)
        c02 = torch.linalg.cross(r0, r2, dim=-1)
        c12 = torch.linalg.cross(r1, r2, dim=-1)
        n01 = torch.sum(c01 * c01, dim=-1)
        n02 = torch.sum(c02 * c02, dim=-1)
        n12 = torch.sum(c12 * c12, dim=-1)
        c = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                        torch.where((n02 >= n12)[..., None], c02, c12))
        nrm2 = torch.sum(c * c, dim=-1, keepdim=True)
        ok = nrm2 > 1e-60
        v = c / torch.sqrt(torch.where(ok, nrm2, one))
        return v, ok[..., 0]

    hi_first = (w2 - w1) >= (w1 - w0)
    lam_a = torch.where(hi_first, w2, w0)
    lam_b = torch.where(hi_first, w0, w2)
    va, ok_a = best_null_vector(lam_a)
    vb_raw, ok_b = best_null_vector(lam_b)
    # the unit x vector by comparison, not by a write of a host scalar
    e0 = (torch.arange(3, device=va.device) == 0).to(dtype).expand_as(va)
    va = torch.where(ok_a[..., None], va, e0)
    least = torch.argmin(torch.abs(va), dim=-1)
    # one-hot by comparison: no host read of the indices on any device
    alt = (least[..., None] == torch.arange(3, device=least.device)).to(
        dtype)
    vb_raw = torch.where(ok_b[..., None], vb_raw, alt)
    vb = vb_raw - torch.sum(vb_raw * va, dim=-1, keepdim=True) * va
    nb2 = torch.sum(vb * vb, dim=-1, keepdim=True)
    ok_nb = nb2 > 1e-60
    cr = torch.linalg.cross(va, alt, dim=-1)
    vb = torch.where(ok_nb, vb / torch.sqrt(torch.where(ok_nb, nb2, one)),
                     cr / torch.clamp(torch.linalg.norm(cr, dim=-1,
                                                        keepdim=True),
                                      min=1e-30))
    vm = torch.linalg.cross(va, vb, dim=-1)
    v2 = torch.where(hi_first[..., None], va, vb)
    v0 = torch.where(hi_first[..., None], vb, va)
    return (torch.stack([w0, w1, w2], dim=-1),
            torch.stack([v0, vm, v2], dim=-1))


def cholesky_solve_6x6(H, g, jitter: float = 0.0):
    """Unrolled Cholesky solve of the SPD 6x6 system H x = g, batched.
    Returns (x, ok); ok is False where a pivot fell to <= 1e-30 (H not
    PD), and then x is not a solution."""
    n = 6
    if jitter:
        H = H + jitter * torch.eye(n, dtype=H.dtype, device=H.device)
    one = torch.ones((), dtype=H.dtype, device=H.device)
    L = [[None] * n for _ in range(n)]
    ok = torch.ones(H.shape[:-2], dtype=torch.bool, device=H.device)
    for j in range(n):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        ok = ok & (s > 1e-30)
        d = torch.sqrt(torch.where(s > 1e-30, s, one))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1), ok


def condition_number(w_asc, eps: float = 1e-12):
    """max |lambda| / max(min lambda, eps) from ascending eigenvalues."""
    return w_asc[..., -1] / torch.clamp(w_asc[..., 0], min=eps)
