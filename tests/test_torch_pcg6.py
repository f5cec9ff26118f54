"""pcg6 (``csrc/pcg6.cu``), the map loop's fast PCG solve, and its plain
twin ``solvers.solve_pcg_fast_plain``.

On the CPU, ``solve_pcg_fast`` routes to the plain twin and returns what
it returns, on a battery of systems: well-conditioned; degenerate in
rotation, in translation and in both; not positive definite (Cholesky
fails); Schur-invalid; NaN in H; each at the shapes (6, 6), (1, 6, 6)
and (128, 6, 6).  The operands the wrapper hands the kernel are views of
the analysis' own tensors whose strides address their elements.

The tests marked ``chip`` run the kernel on the card against the twin
there, on the battery (also with the Schur flag cleared) and on
point-to-plane systems of planar scenes like the map cell's, at B = 1
and B = 128, held to ``chip_smoke.pcg6_gates``: equal branch decisions,
bit-equal x where the Cholesky branch is taken; where PCG is, every stop
legitimate (under the threshold or at the cap, or on the twin's trip),
x of a converged system within float32 rounding of the twin's, each
residual that of its answer; P to float32 rounding; and one device
operation per solve, captured in a CUDA graph and replayed bit-equal to
its eager launch, each replay counted.  The PCG threshold, 1e-6 |g|,
lies a few float32 roundings above the residual's noise, so two
summation orders may stop a few trips apart.  On the CPU the gates
themselves are held: the twin passes against itself, and each fails on
an answer with its fault.
On the card (no JAX there; the tests' conftest imports it):

    python3 -m pytest -q -p no:cacheprovider --noconftest -m chip \\
        tests/test_torch_pcg6.py
"""
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

import chip_smoke as cs

from dcreg_tpu_torch import graphs
from dcreg_tpu_torch.ops import solvers
from dcreg_tpu_torch.ops.degeneracy import (DegeneracyThresholds,
                                            DetectionMethod, HandlingMethod,
                                            analyze)

TH = DegeneracyThresholds()
SCHUR = DetectionMethod.SCHUR_CONDITION_NUMBER
KINDS = ("well", "degenerate_rot", "degenerate_trans", "degenerate_both",
         "not_pd", "schur_invalid", "nan_in_H")
SHAPES = ((), (1,), (128,))


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


def battery(kind, n, seed=0):
    """n float32 systems (H (n, 6, 6), g (n, 6)) of one kind of the
    battery: per 3x3 block eigenvalues 200-400 in a random basis, a weak
    direction (1-10) where degenerate, a negative one (-20 to -50) in the
    translation block where not positive definite, the translation block
    diag(l, l, 0) with g's z translation 0 where Schur-invalid (H's z
    column is zero, as a Jacobian without that column makes it), one
    diagonal NaN in H; rotation-translation coupling about 5."""
    rng = np.random.default_rng([seed, KINDS.index(kind)])
    H = np.zeros((n, 6, 6))
    g = rng.normal(size=(n, 6)) * 100.0
    for b in range(n):
        lam = rng.uniform(200.0, 400.0, 6)
        if kind in ("degenerate_rot", "degenerate_both"):
            lam[rng.integers(3)] = rng.uniform(1.0, 10.0)
        if kind in ("degenerate_trans", "degenerate_both"):
            lam[3 + rng.integers(3)] = rng.uniform(1.0, 10.0)
        if kind == "not_pd":
            lam[3 + rng.integers(3)] = -rng.uniform(20.0, 50.0)
        Rr, Rt = _rotation(rng), _rotation(rng)
        H[b, :3, :3] = Rr @ np.diag(lam[:3]) @ Rr.T
        H[b, 3:, 3:] = Rt @ np.diag(lam[3:]) @ Rt.T
        C = rng.normal(size=(3, 3)) * 5.0
        if kind == "schur_invalid":
            H[b, 3:, 3:] = np.diag([lam[3], lam[4], 0.0])
            C[:, 2] = 0.0
            g[b, 5] = 0.0
        H[b, :3, 3:] = C
        H[b, 3:, :3] = C.T
        if kind == "nan_in_H":
            k = rng.integers(6)
            H[b, k, k] = np.nan
    return (torch.as_tensor(H, dtype=torch.float32),
            torch.as_tensor(g, dtype=torch.float32))


def mixed_battery(n, seed=0):
    """n systems cycling through the battery's kinds."""
    parts = [battery(k, n, seed) for k in KINDS]
    pick = torch.arange(n) % len(KINDS)
    H = torch.stack([parts[k][0][i] for i, k in enumerate(pick.tolist())])
    g = torch.stack([parts[k][1][i] for i, k in enumerate(pick.tolist())])
    return H, g


def map_like(n, seed=0, points=5000):
    """n float32 point-to-plane Gauss-Newton systems of ``points``-point
    scans within 6 m in planar scenes like the map cell's: ground only
    (degenerate in x, y and yaw), ground and walls of one orientation
    (degenerate along them), ground and walls of two, and ground, walls
    and pillars (random horizontal normals); normals with 2% noise,
    weights 0.5-1, residuals of 1 cm."""
    rng = np.random.default_rng(seed)
    H = np.zeros((n, 6, 6))
    g = np.zeros((n, 6))
    for b in range(n):
        p = rng.uniform(-6.0, 6.0, (points, 3)) * [1.0, 1.0, 0.3]
        nrm = np.zeros((points, 3))
        nrm[:, 2] = 1.0
        scene = b % 4
        share = rng.uniform(0.2, 0.5)
        wall = rng.random(points) < share * (scene > 0)
        if scene == 1:
            nrm[wall] = [1.0, 0.0, 0.0]
        elif scene >= 2:
            axis = rng.integers(2, size=points)
            nrm[wall & (axis == 0)] = [1.0, 0.0, 0.0]
            nrm[wall & (axis == 1)] = [0.0, 1.0, 0.0]
        if scene == 3:
            pil = wall & (rng.random(points) < 0.3)
            phi = rng.uniform(0.0, 2.0 * np.pi, int(pil.sum()))
            nrm[pil] = np.stack([np.cos(phi), np.sin(phi),
                                 np.zeros_like(phi)], axis=1)
        nrm = nrm + rng.normal(size=nrm.shape) * 0.02
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        J = np.concatenate([np.cross(p, nrm), nrm], axis=1)
        w = rng.uniform(0.5, 1.0, points)
        r = rng.normal(size=points) * 0.01
        H[b] = (J * w[:, None]).T @ J
        g[b] = -(J * w[:, None]).T @ r
    return (torch.as_tensor(H, dtype=torch.float32),
            torch.as_tensor(g, dtype=torch.float32))


def _equal(a, b):
    """Equal, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        if not torch.equal(a.isnan(), b.isnan()):
            return False
        a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
    return torch.equal(a, b)


# --------------------------------------------------------------------------
# the CPU: the plain twin, and the operands the kernel would read
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=["6x6", "1x6x6", "128x6x6"])
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_routes_to_the_plain_twin(kind, shape, monkeypatch):
    n = shape[0] if shape else 1
    H, g = battery(kind, n)
    H, g = H.reshape(shape + (6, 6)), g.reshape(shape + (6,))
    a = analyze(H, SCHUR, TH, fast=True)
    plain, calls = solvers.solve_pcg_fast_plain, []

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(solvers, "solve_pcg_fast_plain", spy)
    x, info = solvers.solve(H, g, HandlingMethod.PRECONDITIONED_CG, a, TH,
                            telemetry=False, fast=True)
    assert len(calls) == 1
    x_ref, info_ref = plain(H, g, a, TH)
    assert _equal(x, x_ref)
    for got, ref in zip(info, info_ref):
        assert _equal(got, ref)
    # the battery is what it claims to be
    iters, deg = info.pcg_iterations, a.is_degenerate
    if kind == "well":
        assert not deg.any() and (iters == -1).all()
        assert torch.isfinite(x).all()
    elif kind.startswith("degenerate"):
        rot = a.degenerate_mask[..., :3].any(-1)
        trans = a.degenerate_mask[..., 3:].any(-1)
        assert deg.all() and (iters >= 1).all()
        assert bool(rot.all()) == (kind != "degenerate_trans")
        assert bool(trans.all()) == (kind != "degenerate_rot")
        assert torch.isfinite(x).all()
    elif kind == "not_pd":
        assert (iters >= 1).all() and torch.isfinite(x).all()
        _, chol_ok = solvers.linalg.cholesky_solve_6x6(H, g)
        assert not chol_ok.any()
    elif kind == "schur_invalid":
        assert not a.schur_valid.any() and (iters >= 1).all()
        assert torch.equal(info.P_preconditioner,
                           torch.eye(6).expand(shape + (6, 6)))
        assert torch.isfinite(x).all()
    else:
        assert (iters >= 1).all() and x.isnan().any(-1).all()


@pytest.mark.parametrize("shape", SHAPES, ids=["6x6", "1x6x6", "128x6x6"])
def test_kernel_operands_address_the_callers_tensors(shape):
    n = shape[0] if shape else 1
    H, g = battery("degenerate_both", n)
    H, g = H.reshape(shape + (6, 6)), g.reshape(shape + (6,))
    a = analyze(H, SCHUR, TH, fast=True)
    nb, views, strides = solvers.kernel_operands(H, g, a)
    assert nb == n and len(strides) == 17
    k = 0
    for (name, tail), v in zip(solvers._OPERANDS, views):
        t = {"H": H, "g": g}.get(name)
        t = getattr(a, name) if t is None else t
        # the same storage: no copy
        assert v.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr()
        # the kernel's address arithmetic over that storage
        store = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
        idx = torch.full((nb,) + tail, v.storage_offset(), dtype=torch.long)
        for d, size in enumerate((nb,) + tail):
            pos = torch.arange(size).reshape((-1,) + (1,) * (len(tail) - d))
            idx = idx + pos * strides[k + d]
        k += 1 + len(tail)
        assert _equal(store[idx], t.reshape((nb,) + tail))
    assert k == len(strides)


def test_the_launch_refuses_a_cpu_tensor():
    H, g = battery("well", 1)
    a = analyze(H, SCHUR, TH, fast=True)
    with pytest.raises(ValueError, match="CUDA"):
        solvers._launch_cuda(H, g, a, TH)


GATE_FAULTS = ("none", "branch", "cholesky_x", "nan", "stops", "pcg_x",
               "residual", "P", "W_cond")


@pytest.mark.parametrize("fault", GATE_FAULTS)
def test_gates_catch_each_fault(fault):
    H, g = mixed_battery(64, seed=2)
    a = analyze(H, SCHUR, TH, fast=True)
    twin = solvers.solve_pcg_fast_plain(H, g, a, TH)
    x, info = solvers.solve_pcg_fast_plain(H, g, a, TH)
    it, res, g_norm = info.pcg_iterations, info.pcg_residual, g.norm(dim=-1)
    chol = (it < 0).nonzero()[0, 0]
    conv = ((it > 0) & (res <= TH.pcg_tolerance * g_norm)
            & torch.isfinite(x).all(-1)).nonzero()[0, 0]
    if fault == "branch":
        it[conv] = -1
    elif fault == "cholesky_x":
        x[chol, 0] = torch.nextafter(x[chol, 0], torch.tensor(np.inf))
    elif fault == "nan":
        res[chol] = 0.0
    elif fault == "stops":
        it[conv] = TH.pcg_max_iter + 1
    elif fault == "pcg_x":
        # twice the tolerance's upper end
        x[conv] *= 1.0 + 2 * cs.PCG6_X_TOL[1]
    elif fault == "residual":
        res[conv] = g_norm[conv] * 0.5
    elif fault == "P":
        info.P_preconditioner[conv] *= 1.0 + 1e-5
    elif fault == "W_cond":
        info.W_adaptive[conv, 0, 0] = 1.0
    row = cs.pcg6_gates(H, g, (x, info), twin, TH)
    if fault == "none":
        assert row["failed"] == [], row
    else:
        assert fault in row["failed"], row
    assert row["pcg_converged"] > 0 and row["systems"] > row["pcg_systems"]


@pytest.mark.parametrize("fault", ("none", "pcg_x", "residual"))
def test_gates_hold_a_zero_system(fault):
    # a batch lane that is done searches nothing: H = 0 and g = 0, which
    # Cholesky refuses, so PCG answers 0 at once with residual 0
    H, g = mixed_battery(16, seed=4)
    H[3], g[3] = 0.0, 0.0
    a = analyze(H, SCHUR, TH, fast=True)
    twin = solvers.solve_pcg_fast_plain(H, g, a, TH)
    x, info = solvers.solve_pcg_fast_plain(H, g, a, TH)
    assert int(info.pcg_iterations[3]) >= 1 and not x[3].any()
    if fault == "pcg_x":
        x[3, 0] = 1e-3
    elif fault == "residual":
        info.pcg_residual[3] = 1e-3
    row = cs.pcg6_gates(H, g, (x, info), twin, TH)
    assert row["failed"] == ([] if fault == "none" else [fault]), row


# --------------------------------------------------------------------------
# the card: the kernel against the twin
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cases(source, B, dev):
    """(H, g) batches on the card: at B = 1 each system alone, unbatched
    and as (1, 6, 6)."""
    if source == "battery":
        if B == 1:
            sys = [battery(k, 1, seed=5) for k in KINDS]
        else:
            sys = [mixed_battery(B, seed=5)]
    else:
        sys = [map_like(4 if B == 1 else B, seed=11)]
        if B == 1:
            sys = [(H[i:i + 1], g[i:i + 1]) for H, g in sys for i in range(4)]
    out = []
    for H, g in sys:
        H, g = H.to(dev), g.to(dev)
        out.append((H, g))
        if B == 1:
            out.append((H[0], g[0]))
    return out


def _compare(H, g, schur_valid=True):
    """The kernel against the twin on the same analysis (its Schur
    complement marked invalid everywhere where ``schur_valid`` is False),
    held to ``chip_smoke.pcg6_gates``; returns its row."""
    a = analyze(H, SCHUR, TH, fast=True)
    if not schur_valid:
        a = a._replace(schur_valid=torch.zeros_like(a.schur_valid))
    row = cs.pcg6_gates(H, g, solvers.solve_pcg_fast(H, g, a, TH),
                        solvers.solve_pcg_fast_plain(H, g, a, TH), TH)
    assert not row["failed"], row
    return row


@pytest.mark.chip
@pytest.mark.parametrize("B", (1, 128))
@pytest.mark.parametrize("source", ("battery", "map_like"))
def test_kernel_matches_the_twin_on_the_card(cuda, source, B):
    before = solvers.solve_pcg_fast.launches
    cases = _cases(source, B, cuda)
    rows = [_compare(H, g) for H, g in cases]
    if source == "battery":
        # P's identity where the Schur flag says so, whatever its fields
        rows += [_compare(H, g, schur_valid=False) for H, g in cases]
    torch.cuda.synchronize()
    assert solvers.solve_pcg_fast.launches - before == len(rows)
    n = {k: sum(r[k] for r in rows) for k in (
        "systems", "pcg_systems", "pcg_converged", "pcg_iterations_differ")}
    assert n["pcg_converged"] > 0 and n["systems"] > n["pcg_systems"]
    # float32 rounding moves a stop on some systems, an off count all
    assert n["pcg_iterations_differ"] <= n["pcg_systems"] * \
        cs.PCG6_ITERATIONS_DIFFER_SHARE


@pytest.mark.chip
@pytest.mark.parametrize("shape", SHAPES, ids=["6x6", "1x6x6", "128x6x6"])
def test_one_launch_captured_and_replayed(cuda, shape):
    n = shape[0] if shape else 1
    H, g = mixed_battery(n, seed=3) if n > 1 else map_like(1, seed=3)
    H = H.reshape(shape + (6, 6)).to(cuda)
    g = g.reshape(shape + (6,)).to(cuda)
    a = analyze(H, SCHUR, TH, fast=True)
    held = {}

    def part():
        with graphs.mark("solve"):
            held["out"] = solvers.solve_pcg_fast(H, g, a, TH)

    gr = graphs.Graphs("pcg6", graphs.State(), {"solve": part}, cuda)
    # one device operation: no copy, fill or contiguity kernel
    assert gr.nodes["solve"] == 1
    assert gr.modules["solve"] == [("solve", 0, 1)]
    before = (solvers.solve_pcg_fast.launches,
              solvers.solve_pcg_fast.launches_replayed)
    for t in held["out"][1]:
        t.fill_(7)
    held["out"][0].fill_(7)
    gr("solve")
    torch.cuda.synchronize()
    assert solvers.solve_pcg_fast.launches - before[0] == 1
    assert solvers.solve_pcg_fast.launches_replayed - before[1] == 1
    x, info = solvers.solve_pcg_fast(H, g, a, TH)
    assert _equal(held["out"][0], x)
    for got, ref in zip(held["out"][1], info):
        assert _equal(got, ref)
