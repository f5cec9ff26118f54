"""Port parity: the X-ICP baseline (``models/xicp.py``), its three
detectors and two solvers and the engine in all five variants of
``configs/cylinder.yaml`` and ``configs/parkinglot.yaml``, against
dcreg_tpu on the same inputs, f64 on the CPU.

Stated tolerances: the detectors' flags identical, their constraint
values, directions and remapping matrix within rtol 1e-9, atol 1e-12
(eigenvectors compared up to sign, as the Jacobi solver returns them);
the solvers' steps within rtol 1e-9 and atol 1e-12 of their largest
entry; the engines as ``tests/test_torch_baselines.py`` states it
(``assert_results_match``), on the brute-force backend (the CSR grid
runs under the harness).
"""
import numpy as np
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from chip_smoke import synthetic_cylinder
from dcreg_tpu.config import load_config
from dcreg_tpu.models import xicp as jx
from dcreg_tpu.ops.degeneracy import DetectionMethod as JD
from dcreg_tpu.ops.degeneracy import HandlingMethod as JH
from dcreg_tpu_torch import convert
from dcreg_tpu_torch.config import XICPParamsConfig
from dcreg_tpu_torch.models import xicp as tx
from dcreg_tpu_torch.ops.degeneracy import DetectionMethod, HandlingMethod
from test_torch_baselines import assert_results_match

T = torch.from_numpy
CYL = load_config("configs/cylinder.yaml")
PARK = load_config("configs/parkinglot.yaml")
# (config, row) of every XICP variant: the cylinder's XICP and the
# parking lot's four others
ROWS = [(CYL, m) for m in CYL.test_methods if m[0] == "XICP"] + \
    [(PARK, m) for m in PARK.test_methods
     if m[0].startswith("XICP") and m[0] != "XICP"]


def _close(ours, ref, rtol=1e-9, atol=1e-12, **kw):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol,
                               atol=atol, **kw)


@pytest.fixture(scope="module")
def scene():
    """A moved cylinder against itself, its 1-NN correspondences within
    0.5 m and the target normals: the inputs of one XICP iteration."""
    pts = synthetic_cylinder(8, 1500).astype(np.float64)
    T0 = CYL.initial_matrix()
    src_w = pts @ T0[:3, :3].T + 0.3 * T0[:3, 3]
    d = np.sum((src_w[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    idx = np.argmin(d, axis=1)
    mask = d[np.arange(len(pts)), idx] < 0.25
    normals = np.asarray(jx.estimate_normals(jnp.asarray(pts), k=5))[idx]
    tgt = pts[idx]
    F = np.concatenate([np.cross(src_w, normals), normals], axis=1)
    H = (F * mask[:, None]).T @ F
    dot = np.sum((src_w - tgt) * normals, axis=1)
    b = -(F * mask[:, None]).T @ dot
    return dict(src_w=src_w, tgt=tgt, normals=normals, mask=mask, H=H, b=b)


def _cfgs():
    """The JAX and port XICP thresholds of the configs, and a set with
    lower thresholds that drives the ternary detector's partial-constraint
    branches on this small scene."""
    low = dict(enough_info_threshold=60.0, insufficient_info_threshold=30.0,
               high_info_threshold=200.0, solution_remapping_threshold=5.0)
    j_low = PARK.xicp._replace(**low)
    return [(PARK.xicp, XICPParamsConfig(*PARK.xicp)),
            (j_low, XICPParamsConfig(*j_low))]


def _same_directions(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    sign = np.sign(np.sum(ours * ref, axis=0))
    _close(ours * sign, ref)


def _assert_detections_match(dt, dj):
    for f in ("loc_rot", "loc_trans", "n_high_rot"):
        assert np.array_equal(getattr(dt, f).numpy(),
                              np.asarray(getattr(dj, f))), f
    for f in ("constraint_rot", "constraint_trans", "remap_P"):
        _close(getattr(dt, f).numpy(), getattr(dj, f), err_msg=f)
    _same_directions(dt.V_rot.numpy(), dj.V_rot)
    _same_directions(dt.V_trans.numpy(), dj.V_trans)


@pytest.mark.parametrize("which", [0, 1], ids=["config", "low"])
@pytest.mark.parametrize("detector", ["optimized", "equality", "inequality",
                                      "remapping"])
def test_detectors(scene, detector, which):
    jcfg, tcfg = _cfgs()[which]
    s = scene
    J = {k: jnp.asarray(v) for k, v in s.items()}
    P = {k: T(np.ascontiguousarray(v)) for k, v in s.items()}
    if detector == "optimized":
        dj = jx.detect_optimized(J["src_w"], J["normals"], J["H"], J["mask"],
                                 jcfg)
        dt = tx.detect_optimized(P["src_w"], P["normals"], P["H"], P["mask"],
                                 tcfg)
    elif detector == "remapping":
        dj = jx.detect_solution_remapping(J["H"], jcfg)
        dt = tx.detect_solution_remapping(P["H"], tcfg)
    else:
        ineq = detector == "inequality"
        dj = jx.detect_ternary(J["src_w"], J["tgt"], J["normals"], J["H"],
                               J["mask"], ineq, jcfg)
        dt = tx.detect_ternary(P["src_w"], P["tgt"], P["normals"], P["H"],
                               P["mask"], ineq, tcfg)
    _assert_detections_match(dt, dj)


@pytest.mark.parametrize("solver", ["equality", "inequality", "remap",
                                    "directions"])
def test_solvers(scene, solver):
    jcfg, tcfg = _cfgs()[1]
    s = scene
    J = {k: jnp.asarray(v) for k, v in s.items()}
    P = {k: T(np.ascontiguousarray(v)) for k, v in s.items()}
    ineq = solver == "inequality"
    dj = jx.detect_ternary(J["src_w"], J["tgt"], J["normals"], J["H"],
                           J["mask"], ineq, jcfg) if solver in (
        "equality", "inequality") else jx.detect_solution_remapping(J["H"],
                                                                   jcfg)
    dt = tx.XICPDetection(*[T(np.array(v)) for v in dj])
    if solver in ("equality", "inequality"):
        xj = jx._solve_constraint(J["H"], J["b"], dj, ineq, jcfg)
        xt = tx._solve_constraint(P["H"], P["b"], dt, ineq, tcfg)
    else:
        remap = solver == "remap"
        xj = jx._solve_projection(J["H"], J["b"], dj, remap)
        xt = tx._solve_projection(P["H"], P["b"], dt, remap)
    ref = np.asarray(xj)
    _close(xt.numpy(), ref, atol=1e-12 * np.abs(ref).max(initial=1e-300))


@pytest.fixture(scope="module")
def world():
    pts = synthetic_cylinder(11, 1500).astype(np.float64)
    return pts, CYL.initial_matrix()


@pytest.mark.parametrize("cfg,row", ROWS, ids=[m[0] for _, m in ROWS])
def test_xicp_register(world, cfg, row):
    pts, T0 = world
    _, det, hand = row
    params = cfg.icp_params()
    rj = jx.xicp_register(jnp.asarray(pts), jnp.asarray(pts),
                          jnp.asarray(T0[:3, :3]), jnp.asarray(T0[:3, 3]),
                          JD(det), JH(hand), params, cfg.xicp,
                          T_gt=jnp.eye(4))
    rt = tx.xicp_register(T(pts), T(pts), T(T0[:3, :3].copy()),
                          T(T0[:3, 3].copy()), DetectionMethod(det),
                          HandlingMethod(hand),
                          convert.icp_params(params._asdict()),
                          XICPParamsConfig(*cfg.xicp),
                          T_gt=torch.eye(4, dtype=torch.float64),
                          device="cpu")
    assert_results_match(rt, rj)
    assert int(rt.iterations) >= 2
