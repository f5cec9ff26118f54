"""SO(3)/SE(3) manifold math (counterpart of ``dcreg_tpu/ops/se3.py``).

Plain tensor functions, batched over leading dimensions.  Conventions are
the JAX module's: tangent ordering ``[omega(3), v(3)]``, ``boxplus`` is the
right retraction ``(R exp(w), t + R v)``, ``boxplus_left`` the left one
``(exp(w) R, exp(w) t + v)``, Euler poses compose Z * Y * X.
"""
from __future__ import annotations

import math

import torch


def skew(v):
    """Skew-symmetric matrix of a 3-vector."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def _safe_theta(theta2):
    """(small, theta, theta2 with the small entries set to 1): the sqrt
    never sees 0."""
    small = theta2 < 1e-10
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    return small, torch.sqrt(theta2_safe), theta2_safe


def exp_so3(omega):
    """Exponential map so(3) -> SO(3), Rodrigues."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small, theta, theta2_safe = _safe_theta(theta2)
    K = skew(omega)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R):
    """Logarithm map SO(3) -> so(3); near pi the axis comes from the
    diagonal of (R + I) / 2."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    small = theta < 1e-6
    near_pi = theta > math.pi - 1e-3
    odd = small | near_pi
    factor = torch.where(
        odd, torch.full_like(theta, 0.5),
        theta / (2.0 * torch.where(odd, torch.ones_like(sin_t), sin_t)))
    w_generic = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1) * factor[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    s12 = R[..., 1, 0] + R[..., 0, 1]
    s13 = R[..., 2, 0] + R[..., 0, 2]
    ax = axis[..., 0]
    ay = torch.where(s12 < 0, -axis[..., 1], axis[..., 1])
    az = torch.where(s13 < 0, -axis[..., 2], axis[..., 2])
    w_pi = torch.stack([ax, ay, az], dim=-1) * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def right_jacobian_so3(omega):
    """Right Jacobian of SO(3):
    J_r = I - (1 - cos t) / t^2 K + (t - sin t) / t^3 K^2, K = skew(omega),
    with Taylor terms below t^2 = 1e-10."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small, theta, t2 = _safe_theta(theta2)
    K = skew(omega)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (t2 * theta))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    return eye - b[..., None, None] * K + c[..., None, None] * (K @ K)


def right_jacobian_inv_so3(omega):
    """Inverse right Jacobian of SO(3):
    I + K / 2 + (1 / t^2 - cos(t/2) / (2 t sin(t/2))) K^2."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small, theta, t2 = _safe_theta(theta2)
    K = skew(omega)
    half = 0.5 * theta
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        1.0 / t2 - 0.5 * torch.cos(half) / (
            theta * torch.sin(torch.where(small, 0.5, half))))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    return eye + 0.5 * K + cot[..., None, None] * (K @ K)


def point_to_plane_jacobian(point_body, normal, R):
    """Point-to-plane Jacobian rows [-n^T R [p]x, n^T R] for the right
    perturbation: point_body, normal (..., 3), R (..., 3, 3) -> (..., 6)."""
    nR = torch.einsum('...i,...ij->...j', normal, R)
    Jw = -torch.einsum('...j,...jk->...k', nR, skew(point_body))
    return torch.cat([Jw, nR], dim=-1)


def adjoint(R, t):
    """Adjoint Ad(T) = [[R, [t]x R], [0, R]], (..., 6, 6)."""
    top = torch.cat([R, skew(t) @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_matrix(R, t):
    """4x4 homogeneous matrix from (R, t)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # the row (0, 0, 0, 1) by comparison, not by a write of a host scalar
    bottom = (torch.arange(4, device=R.device) == 3).to(top.dtype).expand_as(
        top[..., :1, :])
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(T):
    return T[..., :3, :3], T[..., :3, 3]


def boxplus(R, t, delta):
    """Right retraction: (R exp(w), t + R v)."""
    omega, v = delta[..., :3], delta[..., 3:]
    R_new = R @ exp_so3(omega)
    t_new = t + torch.einsum('...ij,...j->...i', R, v)
    return R_new, t_new


def boxplus_left(R, t, delta):
    """Left retraction: (exp(w) R, exp(w) t + v)."""
    omega, v = delta[..., :3], delta[..., 3:]
    dR = exp_so3(omega)
    return dR @ R, torch.einsum('...ij,...j->...i', dR, t) + v


def orthonormalize(R):
    """Project a nearly-orthonormal matrix back onto SO(3) (Gram-Schmidt on
    rows).  A constant-velocity chain squares any scale/shear defect every
    frame; one projection per prediction pins it at rounding level."""
    r0 = R[..., 0, :]
    r0 = r0 / torch.linalg.norm(r0, dim=-1, keepdim=True)
    r1 = R[..., 1, :]
    r1 = r1 - torch.sum(r0 * r1, dim=-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.norm(r1, dim=-1, keepdim=True)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def euler_zyx_to_rot(roll, pitch, yaw):
    """R = Rz(yaw) Ry(pitch) Rx(roll); angles are tensors of one shape."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                    dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                    dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ], dim=-2)


def pose_error(T_gt, T_est, degrees: bool = True):
    """Translation / rotation error of T_est against T_gt: the error pose
    is T_gt^-1 T_est; returns (|t_err|, angle of R_err)."""
    R_gt, t_gt = se3_from_matrix(T_gt)
    R_est, t_est = se3_from_matrix(T_est)
    R_err = R_gt.transpose(-1, -2) @ R_est
    t_err = torch.einsum('...ji,...j->...i', R_gt, t_est - t_gt)
    trans_error = torch.linalg.norm(t_err, dim=-1)
    trace = R_err[..., 0, 0] + R_err[..., 1, 1] + R_err[..., 2, 2]
    ang = torch.abs(torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)))
    if degrees:
        ang = ang * (180.0 / math.pi)
    return trans_error, ang


def euler_to_lie_jacobian(roll, pitch, yaw):
    """Euler-rate -> angular-velocity covariance Jacobian, inverted in
    closed form; the identity near gimbal lock (|cos pitch| < 1e-6)."""
    from .linalg import inv_3x3
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    one, zero = torch.ones_like(roll), torch.zeros_like(roll)
    J = torch.stack([
        torch.stack([one, zero, sp], dim=-1),
        torch.stack([zero, cr, -sr * cp], dim=-1),
        torch.stack([zero, sr, cr * cp], dim=-1),
    ], dim=-2)
    Jinv, _ = inv_3x3(J)
    gimbal = torch.abs(cp) < 1e-6
    eye = torch.eye(3, dtype=J.dtype, device=J.device)
    return torch.where(gimbal[..., None, None], eye, Jinv)


def pose6d_to_matrix(pose):
    """pose (..., 6) as [roll, pitch, yaw, x, y, z] -> (..., 4, 4)."""
    R = euler_zyx_to_rot(pose[..., 0], pose[..., 1], pose[..., 2])
    return se3_matrix(R, pose[..., 3:6])


def rot_to_quat(R):
    """Rotation matrix -> quaternion (w, x, y, z), branchless Shepperd:
    the best-conditioned of four constructions, normalised, w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) * 0.5
    den = 4.0 * torch.clamp(qw, min=1e-15)
    q0 = torch.stack([qw, (m21 - m12) / den, (m02 - m20) / den,
                      (m10 - m01) / den], dim=-1)
    sx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-30))
    q1 = torch.stack([(m21 - m12) / (2.0 * sx), 0.5 * sx,
                      (m01 + m10) / (2.0 * sx), (m02 + m20) / (2.0 * sx)],
                     dim=-1)
    sy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-30))
    q2 = torch.stack([(m02 - m20) / (2.0 * sy), (m01 + m10) / (2.0 * sy),
                      0.5 * sy, (m12 + m21) / (2.0 * sy)], dim=-1)
    sz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-30))
    q3 = torch.stack([(m10 - m01) / (2.0 * sz), (m02 + m20) / (2.0 * sz),
                      (m12 + m21) / (2.0 * sz), 0.5 * sz], dim=-1)
    choice = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, choice[..., None, None].expand(
        choice.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def rot_to_euler_zyx(R):
    """Rotation matrix -> (roll, pitch, yaw) through the quaternion."""
    q = rot_to_quat(R)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    yaw = torch.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    pitch = torch.arcsin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    roll = torch.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    return roll, pitch, yaw


def matrix_to_pose6d(T):
    """(..., 4, 4) -> (..., 6) as [roll, pitch, yaw, x, y, z]."""
    roll, pitch, yaw = rot_to_euler_zyx(T[..., :3, :3])
    return torch.stack([roll, pitch, yaw,
                        T[..., 0, 3], T[..., 1, 3], T[..., 2, 3]], dim=-1)


def quat_to_rot(q):
    """Quaternion (..., 4) as (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)
