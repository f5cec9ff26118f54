"""Port parity: the SE(3) pose graph (``models/pose_graph.py``) and the
right Jacobians, the adjoint and the quaternion map of ``ops/se3.py``
against dcreg_tpu, in float64 on the CPU.

Stated tolerances: the se3 functions within 1e-12; ``_edge_residual``
within 1e-12; ``_assemble``'s H and g within 1e-9 relative (to their
largest entry) and its cost within 1e-12 relative; ``_block_jacobi_pcg``
within 1e-9 relative; ``optimize_pose_graph`` poses within 1e-8,
iterations and convergence equal, the final cost within 1e-8 relative.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu.models import pose_graph as jpg
from dcreg_tpu.ops import se3 as jse3
from dcreg_tpu_torch import convert
from dcreg_tpu_torch.models import pose_graph as tpg
from dcreg_tpu_torch.ops import se3 as tse3
from test_odometry import _gt_trajectory

T64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)


def _omegas():
    """Rotation vectors at generic angles and below the Taylor switch."""
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.8, (40, 3))
    w[:5] *= 1e-7
    w[5] = 0.0
    return w


def _rotations(n, seed):
    return np.asarray(jse3.exp_so3(jnp.asarray(
        np.random.default_rng(seed).normal(0, 0.7, (n, 3)))))


SE3_CASES = {
    "right_jacobian_so3": lambda m: (m.right_jacobian_so3, (_omegas(),)),
    "right_jacobian_inv_so3": lambda m: (m.right_jacobian_inv_so3,
                                         (_omegas(),)),
    "point_to_plane_jacobian": lambda m: (m.point_to_plane_jacobian, (
        np.random.default_rng(6).normal(0, 3, (40, 3)),
        np.random.default_rng(7).normal(0, 1, (40, 3)), _rotations(40, 8))),
    "adjoint": lambda m: (m.adjoint, (_rotations(40, 9), np.random.default_rng(
        10).normal(0, 2, (40, 3)))),
    "quat_to_rot": lambda m: (m.quat_to_rot, (np.asarray(jse3.rot_to_quat(
        jnp.asarray(_rotations(40, 11)))),)),
}


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_functions_match(name):
    fj, args = SE3_CASES[name](jse3)
    ft, _ = SE3_CASES[name](tse3)
    want = np.asarray(fj(*(jnp.asarray(a) for a in args)))
    got = ft(*(T64(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_right_jacobian_inverse_pair():
    w = T64(_omegas())
    prod = tse3.right_jacobian_so3(w) @ tse3.right_jacobian_inv_so3(w)
    np.testing.assert_allclose(prod.numpy(), np.broadcast_to(np.eye(3),
                                                             prod.shape),
                               atol=1e-12)


# --------------------------------------------------------------------------
# the graph: a drifting odometry chain, one loop closure, a duplicated edge
# and an invalid one
# --------------------------------------------------------------------------

def _graph(F=10, seed=2):
    gt = _gt_trajectory(F)
    rng = np.random.default_rng(seed)
    I, J, Zs = [], [], []
    for i in range(F - 1):
        Z = np.linalg.inv(gt[i]) @ gt[i + 1]
        Zn = Z.copy()
        Zn[:3, :3] = Z[:3, :3] @ np.asarray(jse3.exp_so3(jnp.asarray(
            rng.normal(0, 0.01, 3))))
        Zn[:3, 3] = Z[:3, 3] + rng.normal(0, 0.02, 3)
        I.append(i), J.append(i + 1), Zs.append(Zn)
    init = [gt[0]]
    for k in range(F - 1):
        init.append(init[-1] @ Zs[k])
    # exact closure, a duplicate of edge 3 (must accumulate), an edge
    # marked invalid
    I += [0, 3, 2]
    J += [F - 1, 4, 7]
    Zs += [np.linalg.inv(gt[0]) @ gt[F - 1], Zs[3], np.eye(4)]
    info = np.broadcast_to(np.eye(6), (len(Zs), 6, 6)).copy()
    info[F - 1] *= 100.0
    info[F] *= 0.5
    valid = np.ones(len(Zs), bool)
    valid[-1] = False
    return (gt, np.asarray(init), np.asarray(I), np.asarray(J),
            np.asarray(Zs), info, valid)


@pytest.fixture(scope="module")
def graph():
    gt, init, I, J, Z, info, valid = _graph()
    ej = jpg.make_edges(I, J, jnp.asarray(Z), info=jnp.asarray(info),
                        valid=jnp.asarray(valid))
    et = tpg.make_edges(I, J, Z, info=info, valid=valid, device="cpu")
    return gt, init, ej, et


def test_edge_residual_matches(graph):
    _, init, ej, et = graph
    Ti, Tj = init[np.asarray(ej.i)], init[np.asarray(ej.j)]
    want = jax.vmap(jpg._edge_residual)(jnp.asarray(Ti), jnp.asarray(Tj),
                                         ej.Z)
    got = tpg._edge_residual(T64(Ti), T64(Tj), et.Z)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def _prior(init):
    return (np.asarray([0, 5]), init[[0, 5]],
            np.stack([1e8 * np.eye(6), 3.0 * np.eye(6)]))


def test_assemble_matches(graph):
    _, init, ej, et = graph
    pi, pT, pinf = _prior(init)
    Hj, gj, cj = jpg._assemble(jnp.asarray(init), ej, jnp.asarray(pi),
                               jnp.asarray(pT), jnp.asarray(pinf))
    Ht, gt_, ct = tpg._assemble(T64(init), et, torch.as_tensor(pi), T64(pT),
                                T64(pinf))
    Hj, gj = np.asarray(Hj), np.asarray(gj)
    assert np.abs(Ht.numpy() - Hj).max() <= 1e-9 * np.abs(Hj).max()
    assert np.abs(gt_.numpy() - gj).max() <= 1e-9 * np.abs(gj).max()
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-12)


def test_duplicate_edges_accumulate(graph):
    """Two copies of one edge (information I and I / 2) give the system
    of that edge at 1.5 times its information."""
    _, init, _, et = graph
    keep = torch.ones(et.i.shape[0], dtype=torch.bool)
    keep[10] = False                     # drop the duplicate of edge 3
    single = tpg.PoseGraphEdges(*(f[keep] for f in et))
    info = single.info.clone()
    info[3] *= 1.5
    scaled = single._replace(info=info)
    pi, pT, pinf = _prior(init)
    args = (torch.as_tensor(pi), T64(pT), T64(pinf))
    H1, g1, c1 = tpg._assemble(T64(init), et, *args)
    H2, g2, c2 = tpg._assemble(T64(init), scaled, *args)
    np.testing.assert_allclose(H1.numpy(), H2.numpy(), rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_block_jacobi_pcg_matches(graph):
    _, init, ej, _ = graph
    pi, pT, pinf = _prior(init)
    H, g, _ = jpg._assemble(jnp.asarray(init), ej, jnp.asarray(pi),
                            jnp.asarray(pT), jnp.asarray(pinf))
    W = init.shape[0]
    want = np.asarray(jpg._block_jacobi_pcg(H, g, W))
    got = tpg._block_jacobi_pcg(T64(H), T64(g), W).numpy()
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    # fewer trips than the solve needs: the loop runs them all
    want4 = np.asarray(jpg._block_jacobi_pcg(H, g, W, iters=4))
    got4 = tpg._block_jacobi_pcg(T64(H), T64(g), W, iters=4).numpy()
    assert np.abs(got4 - want4).max() <= 1e-9 * np.abs(want4).max()


@pytest.mark.parametrize("priors", ["gauge_default", "explicit"])
def test_optimize_pose_graph_matches(graph, priors):
    gt, init, ej, et = graph
    kw = {}
    if priors == "explicit":
        pi, pT, pinf = _prior(init)
        kw = dict(prior_idx=pi, prior_T=pT, prior_info=pinf)
    rj = jpg.optimize_pose_graph(
        jnp.asarray(init), ej, **{k: jnp.asarray(v) for k, v in kw.items()})
    rt = tpg.optimize_pose_graph(init, et, device="cpu", **kw)
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost),
                               rtol=1e-8)
    drift0 = np.linalg.norm(init[-1, :3, 3] - gt[-1, :3, 3])
    drift1 = np.linalg.norm(rt.poses.numpy()[-1, :3, 3] - gt[-1, :3, 3])
    assert drift1 < 0.5 * drift0 and float(rt.final_cost) < 1.0


def test_pose_graph_follows_dtype(graph):
    """float32 poses run in float32 and land within 1e-4 m of float64."""
    _, init, _, et = graph
    r64 = tpg.optimize_pose_graph(init, et, device="cpu")
    r32 = tpg.optimize_pose_graph(init.astype(np.float32), et, device="cpu")
    assert r32.poses.dtype == torch.float32
    assert np.abs(r32.poses.double().numpy()
                  - r64.poses.numpy())[:, :3, 3].max() < 1e-4


def test_pose_graph_edges_from_arrays(graph):
    _, init, ej, et = graph
    ec = convert.pose_graph_edges_from_arrays(
        {f: np.asarray(getattr(ej, f)) for f in ej._fields}, device="cpu")
    assert ec.i.dtype == torch.int64 and ec.valid.dtype == torch.bool
    for a, b in zip(ec, et):
        assert torch.equal(a, b)
