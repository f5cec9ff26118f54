"""schur6 (``csrc/schur6.cu``), the fast Schur degeneracy analysis, and its
plain twin ``degeneracy.analyze_fast_plain``.

On the CPU, ``analyze(..., fast=True)`` routes to the plain twin and
returns what the plain analysis returns, on a battery of systems:
well-conditioned; degenerate in rotation, in translation and in both;
Schur-invalid (a singular H_tt or H_RR); a zero H; NaN in H; each at the
shapes (6, 6), (1, 6, 6), (8, 6, 6) and (128, 6, 6).  The operand the
wrapper hands the kernel is a view of the caller's H whose strides address
its elements; the launch refuses a CPU tensor, a float64 H and a shape
that is not (..., 6, 6).

The tests marked ``chip`` run the kernel on the card against the twin
there, on the battery and on point-to-plane systems of planar scenes like
the map cell's, at B = 1, 8 and 128, held to ``chip_smoke.schur6_gates``:
the flags equal, every float field bit-equal, NaN where the twin's are;
one device operation per call, captured in a CUDA graph and replayed
bit-equal to its eager launch, each replay counted; and pcg6 fed the
kernel's analysis answers as when fed the twin's.  On the CPU the gates
themselves are held: the twin passes against itself, and each fails on an
answer with its fault.
On the card (no JAX there; the tests' conftest imports it):

    python3 -m pytest -q -p no:cacheprovider --noconftest -m chip \\
        tests/test_torch_schur6.py
"""
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

import chip_smoke as cs

from dcreg_tpu_torch import graphs
from dcreg_tpu_torch.ops import degeneracy, solvers
from dcreg_tpu_torch.ops.degeneracy import (DegeneracyAnalysis,
                                            DegeneracyThresholds,
                                            DetectionMethod, analyze)
from test_torch_pcg6 import _rotation, map_like

TH = DegeneracyThresholds()
SCHUR = DetectionMethod.SCHUR_CONDITION_NUMBER
KINDS = ("well", "degenerate_rot", "degenerate_trans", "degenerate_both",
         "singular_tt", "singular_rr", "zero", "nan_in_H")
SHAPES = ((), (1,), (8,), (128,))
SHAPE_IDS = ["6x6", "1x6x6", "8x6x6", "128x6x6"]
# the fields the fast path leaves without a 6x6 spectrum
CONSTANT_NAN = ("eigenvalues_full", "eigenvectors_full", "singular_values",
                "cond_full_sub_rot", "cond_full_sub_trans")


def battery(kind, n, seed=0):
    """n float32 systems H (n, 6, 6) of one kind of the battery: per 3x3
    block eigenvalues 200-400 in a random basis, a weak direction (1-10)
    where degenerate; singular_tt and singular_rr: that block diag(l, l, 0)
    with H's matching column of the coupling zero, as a Jacobian without
    that column makes it; zero: H = 0, a batch lane with no valid pair;
    one diagonal NaN in H; rotation-translation coupling about 5."""
    rng = np.random.default_rng([seed, KINDS.index(kind)])
    H = np.zeros((n, 6, 6))
    for b in range(n):
        lam = rng.uniform(200.0, 400.0, 6)
        if kind in ("degenerate_rot", "degenerate_both"):
            lam[rng.integers(3)] = rng.uniform(1.0, 10.0)
        if kind in ("degenerate_trans", "degenerate_both"):
            lam[3 + rng.integers(3)] = rng.uniform(1.0, 10.0)
        Rr, Rt = _rotation(rng), _rotation(rng)
        H[b, :3, :3] = Rr @ np.diag(lam[:3]) @ Rr.T
        H[b, 3:, 3:] = Rt @ np.diag(lam[3:]) @ Rt.T
        C = rng.normal(size=(3, 3)) * 5.0
        if kind == "singular_tt":
            H[b, 3:, 3:] = np.diag([lam[3], lam[4], 0.0])
            C[:, 2] = 0.0
        if kind == "singular_rr":
            H[b, :3, :3] = np.diag([lam[0], lam[1], 0.0])
            C[2, :] = 0.0
        H[b, :3, 3:] = C
        H[b, 3:, :3] = C.T
        if kind == "zero":
            H[b] = 0.0
        if kind == "nan_in_H":
            k = rng.integers(6)
            H[b, k, k] = np.nan
    return torch.as_tensor(H, dtype=torch.float32)


def mixed_battery(n, seed=0):
    """n systems cycling through the battery's kinds."""
    parts = [battery(k, n, seed) for k in KINDS]
    return torch.stack([parts[i % len(KINDS)][i] for i in range(n)])


def _equal(a, b):
    """Equal bits, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        if not torch.equal(a.isnan(), b.isnan()):
            return False
        a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
        bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


# --------------------------------------------------------------------------
# the CPU: the plain twin, and the operand the kernel would read
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_routes_to_the_plain_twin(kind, shape, monkeypatch):
    n = shape[0] if shape else 1
    H = battery(kind, n).reshape(shape + (6, 6))
    plain, calls = degeneracy.analyze_fast_plain, []

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(degeneracy.SCHUR6, "twin", spy)
    before = degeneracy.SCHUR6.launches
    a = analyze(H, SCHUR, TH, fast=True)
    assert len(calls) == 1 and calls[0][0] is H
    assert degeneracy.SCHUR6.launches == before
    ref = degeneracy._analyze(H, SCHUR, TH, fast=True)
    for name, got, want in zip(DegeneracyAnalysis._fields, a, ref):
        tail = {"eigenvalues_full": (6,), "eigenvectors_full": (6, 6),
                "singular_values": (6,), "degenerate_mask": (6,),
                "V_schur_rot": (3, 3), "V_schur_trans": (3, 3)}.get(
                    name, (3,) if name.startswith("lambda") else ())
        assert got.shape == shape + tail, name
        assert _equal(got, want), name
    # the fast path's constants
    for name in CONSTANT_NAN:
        assert getattr(a, name).isnan().all()
    assert torch.isinf(a.cond_full).all()
    # the battery is what it claims to be
    rot = a.degenerate_mask[..., :3].any(-1)
    trans = a.degenerate_mask[..., 3:].any(-1)
    if kind == "well":
        assert a.schur_valid.all() and not a.is_degenerate.any()
        assert not a.degenerate_mask.any()
        assert torch.isfinite(a.V_schur_rot).all()
    elif kind.startswith("degenerate"):
        assert a.schur_valid.all() and a.is_degenerate.all()
        assert bool(rot.all()) == (kind != "degenerate_trans")
        assert bool(trans.all()) == (kind != "degenerate_rot")
        assert not (rot & trans).any() or kind == "degenerate_both"
    else:
        # Schur-invalid: no spectrum, an infinite condition number, which
        # marks the system degenerate with no direction to clamp
        assert not a.schur_valid.any()
        assert a.lambda_schur_rot.isnan().all()
        assert a.lambda_schur_trans.isnan().all()
        assert torch.isinf(a.cond_schur_rot).all()
        assert a.is_degenerate.all() and not a.degenerate_mask.any()
        if kind == "nan_in_H":
            assert a.lambda_diag_rot.isnan().any() \
                or a.lambda_diag_trans.isnan().any()


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_not_fast_keeps_the_plain_analysis(shape, monkeypatch):
    n = shape[0] if shape else 1
    H = battery("degenerate_both", n).reshape(shape + (6, 6)).double()

    def refuse(*args):
        raise AssertionError("the boundary was taken")

    monkeypatch.setattr(degeneracy.SCHUR6, "twin", refuse)
    for method, fast in ((SCHUR, False),
                         (DetectionMethod.FULL_EVD_MIN_EIGENVALUE, True)):
        a = analyze(H, method, TH, fast=fast)
        ref = degeneracy._analyze(H, method, TH, fast=False)
        for got, want in zip(a, ref):
            assert _equal(got, want)
        assert torch.isfinite(a.eigenvalues_full).all()


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_kernel_operands_address_the_callers_tensors(shape):
    n = shape[0] if shape else 1
    # H a view of a larger buffer, as the epilogue's H_last[lane] is
    buf = torch.randn((n + 2, 7, 9))
    H = buf[1:n + 1, :6, 2:8].reshape(shape + (6, 6)) if shape else \
        buf[1, :6, 2:8]
    nb, view, strides = degeneracy.kernel_operands(H)
    assert nb == n and len(strides) == 3
    assert view.untyped_storage().data_ptr() == \
        buf.untyped_storage().data_ptr()
    store = torch.empty(0).set_(buf.untyped_storage())
    idx = torch.full((nb, 6, 6), view.storage_offset(), dtype=torch.long)
    for d, size in enumerate((nb, 6, 6)):
        pos = torch.arange(size).reshape((-1,) + (1,) * (2 - d))
        idx = idx + pos * strides[d]
    assert _equal(store[idx], H.reshape(nb, 6, 6))


REFUSALS = ("cpu", "float64", "shape")


@pytest.mark.parametrize("case", REFUSALS)
def test_the_launch_refuses(case):
    H = battery("well", 1)
    err, match = ValueError, "CUDA"
    if case == "float64":
        H, err, match = H.double(), TypeError, "float32"
    elif case == "shape":
        H, match = H[..., :5, :5], "shape"
    with pytest.raises(err, match=match):
        degeneracy._launch(H, TH)


def test_the_outputs_are_contiguous_blocks():
    # the launch's outputs as the kernel writes them: each field a
    # contiguous block of one buffer, in the twin's shapes and dtypes
    nb, batch = 5, (5,)
    n_float, n_flag = degeneracy._N_FLOAT, degeneracy._N_FLAG
    assert (n_float, n_flag) == (85, 8)
    out = torch.arange(n_float * nb, dtype=torch.float32)
    fields = degeneracy._carve(out, degeneracy._FLOAT_FIELDS, batch, nb)
    twin = degeneracy.analyze_fast_plain(mixed_battery(nb), TH)
    at = 0
    for name, tail in degeneracy._FLOAT_FIELDS:
        t = fields[name]
        assert t.shape == getattr(twin, name).shape and t.is_contiguous()
        assert t.data_ptr() == out.data_ptr() + 4 * at * nb
        at += int(np.prod(tail, dtype=int))
    flags = torch.zeros(n_flag * nb, dtype=torch.bool)
    for name, t in degeneracy._carve(flags, degeneracy._FLAG_FIELDS, batch,
                                     nb).items():
        assert t.shape == getattr(twin, name).shape
        assert t.dtype == getattr(twin, name).dtype == torch.bool


GATE_FAULTS = ("none",) + DegeneracyAnalysis._fields + ("nan", "zero_sign")


@pytest.mark.parametrize("fault", GATE_FAULTS)
def test_gates_catch_each_fault(fault):
    H = mixed_battery(64, seed=2)
    twin = degeneracy.analyze_fast_plain(H, TH)
    out = DegeneracyAnalysis(*[t.clone() for t in
                               degeneracy.analyze_fast_plain(H, TH)])
    well = 0                            # a well-conditioned system
    want = fault
    if fault in DegeneracyAnalysis._fields \
            and getattr(out, fault).dtype == torch.bool:
        t = getattr(out, fault)
        t[well] = ~t[well]
    elif fault == "nan":
        out.lambda_schur_rot[well, 1], want = float("nan"), \
            "lambda_schur_rot"
    elif fault == "zero_sign":
        twin.V_schur_trans[well, 0, 0] = 0.0
        out.V_schur_trans[well, 0, 0], want = -0.0, "V_schur_trans"
    elif fault != "none":
        t = getattr(out, fault)
        if fault in CONSTANT_NAN + ("cond_full",):
            # a constant field that is not its constant
            t[well] = 1.0
        else:
            # one unit in the last place
            flat = t[well].reshape(-1)
            flat[0] = torch.nextafter(flat[0], torch.tensor(np.inf))
    row = cs.schur6_gates(out, twin)
    assert row["systems"] == 64 and row["degenerate"] > 0
    assert 0 < row["schur_valid"] < 64
    if fault == "none":
        assert row["failed"] == [] and sum(row["differ"].values()) == 0
    else:
        assert row["failed"] == [want], row
        assert row["differ"][want] >= 1
        assert row["shown"][want][0][0] == well


# --------------------------------------------------------------------------
# the card: the kernel against the twin
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cases(source, B, dev):
    """H batches on the card: at B = 1 each system alone, unbatched and
    as (1, 6, 6)."""
    if source == "battery":
        if B == 1:
            sys = [battery(k, 1, seed=5) for k in KINDS]
        else:
            sys = [mixed_battery(B, seed=5)]
    else:
        H, _ = map_like(4 if B == 1 else B, seed=11)
        sys = [H[i:i + 1] for i in range(4)] if B == 1 else [H]
    out = []
    for H in sys:
        H = H.to(dev)
        out.append(H)
        if B == 1:
            out.append(H[0])
    return out


@pytest.mark.chip
@pytest.mark.parametrize("B", (1, 8, 128))
@pytest.mark.parametrize("source", ("battery", "map_like"))
def test_kernel_matches_the_twin_on_the_card(cuda, source, B):
    before = degeneracy.SCHUR6.launches
    cases = _cases(source, B, cuda)
    rows = []
    for H in cases:
        row = cs.schur6_gates(analyze(H, SCHUR, TH, fast=True),
                              degeneracy.analyze_fast_plain(H, TH))
        assert not row["failed"], row
        rows.append(row)
    torch.cuda.synchronize()
    assert degeneracy.SCHUR6.launches - before == len(cases)
    if source == "map_like":
        # the planar scenes are degenerate in some systems, not all
        n = {k: sum(r[k] for r in rows) for k in ("systems", "degenerate")}
        assert 0 < n["degenerate"] < n["systems"]


@pytest.mark.chip
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_one_launch_captured_and_replayed(cuda, shape):
    n = shape[0] if shape else 1
    H = mixed_battery(n, seed=3) if n > 1 else map_like(1, seed=3)[0]
    H = H.reshape(shape + (6, 6)).to(cuda)
    held = {}

    def part():
        with graphs.mark("degeneracy"):
            held["out"] = analyze(H, SCHUR, TH, fast=True)

    gr = graphs.Graphs("schur6", graphs.State(), {"step": part}, cuda)
    # one device operation: no copy, fill or contiguity kernel
    assert gr.nodes["step"] == 1
    assert gr.modules["step"] == [("degeneracy", 0, 1)]
    before = (degeneracy.SCHUR6.launches,
              degeneracy.SCHUR6.launches_replayed)
    for t in held["out"]:
        t.fill_(True if t.dtype == torch.bool else 7.0)
    gr("step")
    torch.cuda.synchronize()
    assert degeneracy.SCHUR6.launches - before[0] == 1
    assert degeneracy.SCHUR6.launches_replayed - before[1] == 1
    eager = analyze(H, SCHUR, TH, fast=True)
    for got, want in zip(held["out"], eager):
        assert _equal(got, want)


@pytest.mark.chip
@pytest.mark.parametrize("B", (1, 8, 128))
def test_pcg6_reads_the_kernels_analysis(cuda, B):
    H, g = map_like(B, seed=7)
    Hb = mixed_battery(B, seed=7)
    H, g = torch.cat([H, Hb]).to(cuda), torch.cat([g, g]).to(cuda)
    ours = analyze(H, SCHUR, TH, fast=True)
    twin = degeneracy.analyze_fast_plain(H, TH)
    x, info = solvers.solve_pcg_fast(H, g, ours, TH)
    x_t, info_t = solvers.solve_pcg_fast(H, g, twin, TH)
    assert _equal(x, x_t)
    for got, want in zip(info, info_t):
        assert _equal(got, want)
