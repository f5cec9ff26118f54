"""Sliding-window pose-graph optimization on SE(3) (counterpart of
``dcreg_tpu/models/pose_graph.py``).

Poses T_0..T_{W-1}; edges (i, j) with measured relative transforms Z_ij
and 6x6 information matrices; unary priors.  Cost:

    sum_e || log( Z_e^-1 T_i^-1 T_j ) ||^2_{Info_e}  +  priors

Gauss-Newton with a right perturbation on every pose: the edge residuals
and Jacobians are batched tensor ops over the edges, the (6W, 6W) normal
system is scatter-added from 6x6 blocks (W is a window of at most a few
hundred poses, so the system is dense), and each step solves it by
block-Jacobi-preconditioned CG, the JAX ``fori_loop``'s masked trips.  A
strong prior on pose 0 fixes the gauge.  The GN loop is a prologue, a
step and an epilogue (``PoseGraphLoop``), replayed as CUDA graphs on
the card (``graphs``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import graphs
from ..ops import linalg, se3
from ..utils import check_precise, resolve_device


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor      # (E,) int64 source pose index
    j: torch.Tensor      # (E,) int64 target pose index
    Z: torch.Tensor      # (E, 4, 4) measured T_i^-1 T_j
    info: torch.Tensor   # (E, 6, 6) information matrix (weight)
    valid: torch.Tensor  # (E,) bool


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor       # (W, 4, 4) optimized
    iterations: int           # GN steps executed
    final_cost: torch.Tensor  # ()
    converged: bool


def make_edges(i, j, Z, info=None, valid=None, device=None) -> PoseGraphEdges:
    """Edges on ``device`` (cuda unless told otherwise); ``info``
    defaults to the identity, ``valid`` to all edges."""
    dev = resolve_device(device)
    Z = torch.as_tensor(Z, device=dev)
    E = Z.shape[0]
    info = (torch.eye(6, dtype=Z.dtype, device=dev).expand(E, 6, 6)
            if info is None else torch.as_tensor(info, device=dev))
    valid = (torch.ones(E, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, device=dev).bool())
    return PoseGraphEdges(i=torch.as_tensor(i, device=dev).long(),
                          j=torch.as_tensor(j, device=dev).long(), Z=Z,
                          info=info, valid=valid)


def _edge_residual(T_i, T_j, Z):
    """Batched over leading dimensions: r = log(Z^-1 T_i^-1 T_j) as
    [omega, v], and the 6x6 Jacobians with respect to right perturbations
    of T_i and T_j: J_j = Jr^-1(omega) on both diagonal blocks,
    J_i = -J_j Ad(E^-1) with E = Z^-1 T_i^-1 T_j."""
    R_i, t_i = se3.se3_from_matrix(T_i)
    R_j, t_j = se3.se3_from_matrix(T_j)
    R_z, t_z = se3.se3_from_matrix(Z)
    mv = lambda A, x: torch.einsum("...ij,...j->...i", A, x)
    R_ij = R_i.transpose(-1, -2) @ R_j
    t_ij = mv(R_i.transpose(-1, -2), t_j - t_i)
    R_e = R_z.transpose(-1, -2) @ R_ij
    t_e = mv(R_z.transpose(-1, -2), t_ij - t_z)
    omega = se3.log_so3(R_e)
    # the translation part of the se(3) log through Jr^-1(-omega)
    v = mv(se3.right_jacobian_inv_so3(-omega), t_e)
    r = torch.cat([omega, v], dim=-1)
    Jri = se3.right_jacobian_inv_so3(omega)
    zero = torch.zeros_like(Jri)
    J_j = torch.cat([torch.cat([Jri, zero], dim=-1),
                     torch.cat([zero, Jri], dim=-1)], dim=-2)
    R_et = R_e.transpose(-1, -2)
    J_i = -(J_j @ se3.adjoint(R_et, -mv(R_et, t_e)))
    return r, J_i, J_j


def _assemble(poses, edges: PoseGraphEdges, prior_idx, prior_T, prior_info):
    """Edge and prior residuals -> scatter-added (6W, 6W) H, (6W,) g and
    the cost."""
    W = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    mv = lambda A, x: torch.einsum("...ij,...j->...i", A, x)
    tr = lambda A: A.transpose(-1, -2)
    r, J_i, J_j = _edge_residual(poses[edges.i], poses[edges.j], edges.Z)
    info = edges.info * edges.valid.to(dtype)[:, None, None]
    H_ii = tr(J_i) @ info @ J_i
    H_ij = tr(J_i) @ info @ J_j
    H_jj = tr(J_j) @ info @ J_j
    Ir = mv(info, r)
    H = torch.zeros((W, W, 6, 6), dtype=dtype, device=dev)
    g = torch.zeros((W, 6), dtype=dtype, device=dev)
    H.index_put_((edges.i, edges.i), H_ii, accumulate=True)
    H.index_put_((edges.i, edges.j), H_ij, accumulate=True)
    H.index_put_((edges.j, edges.i), tr(H_ij), accumulate=True)
    H.index_put_((edges.j, edges.j), H_jj, accumulate=True)
    g.index_put_((edges.i,), -mv(tr(J_i), Ir), accumulate=True)
    g.index_put_((edges.j,), -mv(tr(J_j), Ir), accumulate=True)
    cost = torch.sum(r * Ir)

    # unary priors: the residual of pose idx against T_p, log(T_p^-1 T_idx)
    eye = torch.eye(4, dtype=dtype, device=dev).expand(prior_T.shape)
    r_p, _, J = _edge_residual(eye, poses[prior_idx], prior_T)
    Ir_p = mv(prior_info, r_p)
    H.index_put_((prior_idx, prior_idx), tr(J) @ prior_info @ J,
                 accumulate=True)
    g.index_put_((prior_idx,), -mv(tr(J), Ir_p), accumulate=True)
    cost = cost + torch.sum(r_p * Ir_p)
    return (H.permute(0, 2, 1, 3).reshape(6 * W, 6 * W), g.reshape(6 * W),
            cost)


def _block_jacobi_pcg(H, g, W, iters: int = 64, damping: float = 1e-8):
    """CG on (H + damping I) x = g with the inverses of H's 6x6 diagonal
    blocks as preconditioner: ``iters`` trips, the JAX body's masked
    ones.  From the trip that meets the residual bound (or meets a
    vanishing p.Hp) on, ``alpha`` is 0 and r, z, p and rz are kept, so x
    stays as that trip left it, with no host read."""
    n = 6 * W
    dtype, dev = H.dtype, H.device
    H = H + damping * torch.eye(n, dtype=dtype, device=dev)
    ar = torch.arange(W, device=dev)
    diag = H.reshape(W, 6, W, 6)[ar, :, ar, :]
    w, V = linalg.symmetric_eigh(diag)
    w_inv = 1.0 / torch.clamp(torch.abs(w), min=1e-12) * torch.sign(
        torch.where(w == 0, 1.0, w))
    P_blocks = torch.einsum("wij,wj,wkj->wik", V, w_inv, V)

    def applyP(r):
        return torch.einsum("wij,wj->wi", P_blocks, r.reshape(W, 6)).reshape(n)

    x = torch.zeros(n, dtype=dtype, device=dev)
    r = g
    z = applyP(r)
    p = z
    rz = r @ z
    thresh = 1e-10 * torch.clamp(torch.linalg.norm(g), min=1e-30)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        Hp = H @ p
        pHp = p @ Hp
        safe = torch.abs(pHp) > 1e-30
        alpha = torch.where(safe & ~done, rz / torch.where(safe, pHp, 1.0),
                            0.0)
        x = x + alpha * p
        r_new = r - alpha * Hp
        z_new = applyP(r_new)
        rz_new = r_new @ z_new
        rz_ok = torch.abs(rz) > 1e-30
        beta = torch.where(rz_ok, rz_new / torch.where(rz_ok, rz, 1.0), 0.0)
        p_new = z_new + beta * p
        now = done | (torch.linalg.norm(r_new) <= thresh) | ~safe
        r = torch.where(done, r, r_new)
        z = torch.where(done, z, z_new)
        p = torch.where(done, p, p_new)
        rz = torch.where(done, rz, rz_new)
        done = now
    return x


class PoseGraphLoop:
    """One configuration of ``optimize_pose_graph`` split into the parts
    of its compiled loop over a ``graphs.State`` (as ``icp.PairLoop``):
    ``load`` copies the window, the edges and the priors into the state;
    the ``prologue`` sets the poses, the step counter ``k`` and the
    ``done`` flag; the ``step`` is one GN step (``_assemble``, the
    masked block-Jacobi CG, the finiteness guard, the retraction) and
    sets ``done`` (converged) once |dx| < tol W; the ``epilogue`` the
    final cost.  Every
    tensor is copied in, so ``key()`` holds statics only."""

    name = "optimize_pose_graph"

    def __init__(self, W: int, E: int, P: int, cg_iters: int, tol: float,
                 device, dtype):
        self.W, self.E, self.P = W, E, P
        self.cg_iters, self.tol = cg_iters, tol
        self.dev, self.dtype = device, dtype

    def key(self) -> tuple:
        return (self.name, self.W, self.E, self.P, self.cg_iters, self.tol,
                str(self.dtype), str(self.dev))

    def load(self, S, poses0, edges: PoseGraphEdges, prior_idx, prior_T,
             prior_info) -> None:
        S.put("poses0", poses0)
        S.put_tuple("edges", edges)
        S.put("prior_idx", prior_idx)
        S.put("prior_T", prior_T)
        S.put("prior_info", prior_info)

    def _system(self, S, poses):
        return _assemble(poses, S.get_tuple("edges", PoseGraphEdges),
                         S.prior_idx, S.prior_T, S.prior_info)

    def prologue(self, S) -> None:
        S.put("poses", S.poses0)
        S.put("k", torch.zeros((), dtype=torch.int64, device=self.dev))
        S.put("done", torch.zeros((), dtype=torch.bool, device=self.dev))

    def step(self, S) -> None:
        W = self.W
        H, g, _ = self._system(S, S.poses)
        dx = _block_jacobi_pcg(H, g, W, iters=self.cg_iters)
        dx = torch.where(torch.all(torch.isfinite(dx)), dx,
                         torch.zeros_like(dx))
        R, t = se3.boxplus(S.poses[:, :3, :3], S.poses[:, :3, 3],
                           dx.reshape(W, 6))
        S.put("poses", se3.se3_matrix(R, t))
        S.put("done", torch.linalg.norm(dx) < self.tol * W)
        S.put("k", S.k + 1)

    def epilogue(self, S) -> None:
        S.put("final_cost", self._system(S, S.poses)[2])


def optimize_pose_graph(poses0, edges: PoseGraphEdges, prior_idx=None,
                        prior_T=None, prior_info=None,
                        max_gn_iters: int = 10, cg_iters: int = 64,
                        tol: float = 1e-8, device=None,
                        graph=None) -> PoseGraphResult:
    """Gauss-Newton over a window of poses (W, 4, 4), in their dtype, on
    ``device`` (cuda unless told otherwise).  Without priors, pose 0 is
    pinned at its initial value with information 1e8 I (the gauge).  Stops
    after ``max_gn_iters`` steps or at a step with |dx| < tol W; a step
    that is not finite is dropped.  On the card the steps (``PoseGraphLoop``)
    replay CUDA graphs, a pass in one launch with the stop test on the
    card (``ops/loop_cond``); ``graph=False`` runs
    them eagerly, and on the CPU they run eagerly and ``graph=True``
    raises."""
    check_precise()
    dev = resolve_device(device)
    graphed = graphs.use_graphs(dev, graph)
    poses = torch.as_tensor(poses0, device=dev)
    dtype = poses.dtype
    W = poses.shape[0]
    edges = PoseGraphEdges(i=edges.i.to(dev), j=edges.j.to(dev),
                           Z=edges.Z.to(dev, dtype),
                           info=edges.info.to(dev, dtype),
                           valid=edges.valid.to(dev))
    if prior_idx is None:
        prior_idx = torch.zeros(1, dtype=torch.long, device=dev)
        prior_T = poses[:1]
        prior_info = 1e8 * torch.eye(6, dtype=dtype, device=dev)[None]
    else:
        prior_idx = torch.as_tensor(prior_idx, device=dev).long()
        prior_T = torch.as_tensor(prior_T, dtype=dtype, device=dev)
        prior_info = torch.as_tensor(prior_info, dtype=dtype, device=dev)
    loop = PoseGraphLoop(W, edges.i.shape[0], prior_idx.shape[0], cg_iters,
                         tol, dev, dtype)
    run, S = graphs.bind(
        loop, lambda S: loop.load(S, poses, edges, prior_idx, prior_T,
                                  prior_info), graphed, loop.name, dev)
    graphs.drive(run, S, max_gn_iters)
    copy = graphs.detached if graphed else (lambda x: x)
    return PoseGraphResult(poses=copy(S.poses), iterations=int(S.k),
                           final_cost=copy(S.final_cost),
                           converged=bool(S.done))


def assemble_sharded(mesh, poses, edges: PoseGraphEdges, prior_idx, prior_T,
                     prior_info):
    """The normal system with the edges sharded over the mesh's ``data``
    axis: each rank assembles its share of the edges (E must divide by
    the axis) with the priors, the (6W, 6W) H, g and the cost are summed
    over ``data``, and the (n_data - 1) extra copies of the priors come
    off again -- the window-parallel analogue of the GN point reduction.
    Every rank of the mesh calls it; it runs on ``mesh.device``."""
    from ..parallel.sharded import _all_reduce
    n_data = mesh.shape["data"]
    E = edges.i.shape[0]
    if E % n_data:
        raise ValueError(f"{E} edges do not divide over {n_data} data "
                         "shards")
    dev = mesh.device
    rows = slice(mesh.coords[0] * (E // n_data),
                 (mesh.coords[0] + 1) * (E // n_data))
    local = PoseGraphEdges(*(x[rows].to(dev) for x in edges))
    poses = poses.to(dev)
    H, g, cost = _assemble(poses, local, prior_idx, prior_T, prior_info)
    W6 = H.shape[0]
    tot = _all_reduce(mesh, torch.cat([H.reshape(-1), g, cost.reshape(1)]))
    H, g, cost = tot[:W6 * W6].reshape(W6, W6), tot[W6 * W6:-1], tot[-1]
    Hp, gp, cp = _prior_system(poses, prior_idx, prior_T, prior_info)
    scale = n_data - 1
    return H - scale * Hp, g - scale * gp, cost - scale * cp


def _prior_system(poses, prior_idx, prior_T, prior_info):
    """The normal system of the priors alone (one invalid edge)."""
    dtype, dev = poses.dtype, poses.device
    empty = PoseGraphEdges(
        i=torch.zeros(1, dtype=torch.long, device=dev),
        j=torch.zeros(1, dtype=torch.long, device=dev),
        Z=torch.eye(4, dtype=dtype, device=dev)[None],
        info=torch.zeros((1, 6, 6), dtype=dtype, device=dev),
        valid=torch.zeros(1, dtype=torch.bool, device=dev))
    return _assemble(poses, empty, prior_idx, prior_T, prior_info)
