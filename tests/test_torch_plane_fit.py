"""plane_fit (``csrc/plane_fit.cu``), the neighbours' plane fit of the
correspondence tail, and its plain twin ``soa_tail._plane_fit_plain``.

On the CPU, ``soa_tail._plane_fit`` routes to the plain twin and returns
what it returns, on a battery of neighbourhoods: planar, thick,
collinear, coincident, with missing neighbours (id -1, which the twin
reads as point 0) and with NaN in the target; each at B = 1, 8 and 128
lanes, the ids a view ``idx[:, :k, :N]`` of a larger buffer as the loop
hands them.  The operands the wrapper hands the kernel are the caller's
tensors, whose strides address their elements; the launch refuses a CPU
tensor, a wrong dtype and k above the kernel's cap.

The tests marked ``chip`` run the kernel on the card against the twin
there, on the battery and on map-like neighbourhoods (the 5 nearest
points of a scan's points in a ground, walls and pillars scene, id -1
beyond the search radius) at B = 1, 8 and 128, held to
``chip_smoke.plane_fit_gates``: fit_ok and plane_ok equal, the normal and
offset bit-equal; and one device operation per call, captured in a CUDA
graph and replayed bit-equal to its eager launch, each replay counted.
On the CPU the gates themselves are held: the twin passes against
itself, and each fails on an answer with its fault.
On the card (no JAX there; the tests' conftest imports it):

    python3 -m pytest -q -p no:cacheprovider --noconftest -m chip \\
        tests/test_torch_plane_fit.py
"""
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

import chip_smoke as cs

from dcreg_tpu_torch import graphs
from dcreg_tpu_torch.ops import soa_tail
from dcreg_tpu_torch.ops.correspondence import CorrespondenceParams

PARAMS = CorrespondenceParams()
K = PARAMS.k
KINDS = ("planar", "thick", "collinear", "coincident", "missing",
         "nan_in_target")
LANES = (1, 8, 128)
POINTS = 24          # points per lane of the battery


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


def loop_layout(idx):
    """``idx`` (B, k, N) as the loop hands it: a view ``[:, :k, :N]`` of a
    larger buffer whose other entries are ids that are not neighbours."""
    B, k, N = idx.shape
    buf = torch.randint(0, 7, (B, k + 3, N + 13), dtype=torch.int32,
                        device=idx.device)
    buf[:, :k, :N] = idx
    return buf[:, :k, :N]


def battery(kind, B, seed=0, N=POINTS):
    """(target (M, 3) float32, idx (B, k, N) int32 in the loop's layout) for
    one kind of the battery: each point's k neighbours are points of its
    own, spread 0.1-0.5 m in a random frame whose xy plane passes 5-40 m
    from the origin (the fit's plane n.p + d = 0 takes d = 1 / |x|, which
    loses precision where a plane passes through the origin): planar (1 mm
    off that plane), thick (five vertices of an octahedron of radius
    0.8 m), collinear (on a line), coincident (all one point); missing:
    planar with 1 to k - 1 ids -1 (point 0 stands in for them);
    nan_in_target: planar with one coordinate of some points NaN."""
    rng = np.random.default_rng([seed, KINDS.index(kind), B])
    pts = np.zeros((B, N, K, 3))
    octahedron = np.array([[0.8, 0, 0], [-0.8, 0, 0], [0, 0.8, 0],
                           [0, -0.8, 0], [0, 0, 0.8]])[:K]
    for b in range(B):
        for n in range(N):
            local = rng.uniform(-1.0, 1.0, (K, 3)) \
                * rng.uniform(0.1, 0.5, 3)
            if kind == "thick":
                local = octahedron + rng.normal(size=(K, 3)) * 0.05
            elif kind == "collinear":
                local[:, 1:] = 0.0
            elif kind == "coincident":
                local[:] = local[0]
            else:
                local[:, 2] = rng.normal(size=K) * 1e-3
            off = [rng.uniform(-30.0, 30.0), rng.uniform(-30.0, 30.0),
                   rng.choice([-1.0, 1.0]) * rng.uniform(5.0, 40.0)]
            pts[b, n] = (local + off) @ _rotation(rng).T
    target = np.concatenate([rng.uniform(-40.0, 40.0, (1, 3)),
                             pts.reshape(-1, 3)])
    idx = 1 + np.arange(B * N * K).reshape(B, N, K).transpose(0, 2, 1)
    if kind == "missing":
        for b in range(B):
            for n in range(N):
                gone = rng.choice(K, rng.integers(1, K), replace=False)
                idx[b, gone, n] = -1
    if kind == "nan_in_target":
        target[1 + rng.integers(B * N * K, size=B * N // 2),
               rng.integers(3)] = np.nan
    return (torch.as_tensor(target, dtype=torch.float32),
            loop_layout(torch.as_tensor(idx, dtype=torch.int32)))


def map_like(B, device, seed=0, N=1000, chunk=4096):
    """(target, idx) of B scans of N points in a ground, walls and pillars
    scene (``chip_smoke.synthetic_map``, 200,000 points over 40 m, scan
    points with 3 mm of noise): each scan point's k nearest target points
    by brute force on ``device``, id -1 beyond the search radius, in the
    loop's layout."""
    world = torch.as_tensor(cs.synthetic_map(200_000, 40.0, seed),
                            dtype=torch.float32, device=device)
    rng = np.random.default_rng([seed, B])
    pick = rng.choice(world.shape[0], B * N, replace=False)
    q = world[torch.as_tensor(pick, device=device)] + torch.as_tensor(
        rng.normal(size=(B * N, 3)) * 0.003, dtype=torch.float32,
        device=device)
    out = []
    for lo in range(0, q.shape[0], chunk):
        d, i = torch.topk(torch.cdist(q[lo:lo + chunk], world), K,
                          largest=False)
        out.append(torch.where(d <= PARAMS.search_radius, i, -1))
    idx = torch.cat(out).to(torch.int32).reshape(B, N, K).transpose(1, 2)
    return world, loop_layout(idx)


def _equal(a, b):
    """Equal bits, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        if not torch.equal(a.isnan(), b.isnan()):
            return False
        a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# --------------------------------------------------------------------------
# the CPU: the plain twin, and the operands the kernel would read
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_routes_to_the_plain_twin(kind, B, monkeypatch):
    target, idx = battery(kind, B)
    assert not idx.is_contiguous()
    plain, calls = soa_tail._plane_fit_plain, []

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(soa_tail, "_plane_fit_plain", spy)
    out = soa_tail._plane_fit(target, idx, PARAMS)
    assert len(calls) == 1 and calls[0][1] is idx
    ref = plain(target, idx, PARAMS)
    for got, want in zip(out, ref):
        assert got.shape == (B, POINTS) and _equal(got, want)
    # the battery is what it claims to be
    nox, noy, noz, d_off, fit_ok, plane_ok = out
    unit = (nox * nox + noy * noy + noz * noz - 1.0).abs() < 1e-5
    if kind == "planar":
        assert fit_ok.all() and plane_ok.all() and unit.all()
    elif kind == "thick":
        assert fit_ok.all() and not plane_ok.any()
    elif kind in ("collinear", "coincident"):
        # the rank handling leaves a unit normal through the points almost
        # everywhere (where the centroid lies along the one direction the
        # rounded covariance still holds, the offset's denominator
        # vanishes and the fit is refused), and nothing that is not finite
        assert fit_ok.float().mean() > 0.99
        assert unit[fit_ok].all() and plane_ok[fit_ok].all()
        assert torch.isfinite(torch.stack(out[:4])).all()
    elif kind == "missing":
        # a missing neighbour is point 0, not skipped
        as_zero = plain(target, torch.clamp(idx, min=0), PARAMS)
        for got, want in zip(out, as_zero):
            assert _equal(got, want)
        assert not plane_ok.all()
    else:
        hit = torch.isnan(target[idx.long()]).any(-1).any(1)
        assert hit.any() and (~hit).any()
        assert nox[hit].isnan().all() and not fit_ok[hit].any()
        assert not plane_ok[hit].any()
        assert fit_ok[~hit].all() and plane_ok[~hit].all()


@pytest.mark.parametrize("B", LANES)
def test_kernel_operands_address_the_callers_tensors(B):
    target, idx = battery("planar", B)
    # the target a column view of a wider array, as a strided caller's
    wide = torch.cat([target, torch.zeros(target.shape[0], 2)], 1)
    target = wide[:, :3]
    nb, k, N, strides = soa_tail.kernel_operands(target, idx)
    assert (nb, k, N) == (B, K, POINTS) and len(strides) == 5
    assert idx._base is not None            # the loop's view, not a copy
    for t, st in ((target, strides[:2]), (idx, strides[2:])):
        store = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
        at = torch.full(t.shape, t.storage_offset(), dtype=torch.long)
        for d, size in enumerate(t.shape):
            pos = torch.arange(size).reshape((-1,) + (1,) * (t.ndim - 1 - d))
            at = at + pos * st[d]
        assert _equal(store[at], t)


REFUSALS = ("cpu", "float64_target", "int64_ids", "k_above_cap")


@pytest.mark.parametrize("case", REFUSALS)
def test_the_launch_refuses(case):
    target, idx = battery("planar", 1)
    err, match = ValueError, "CUDA"
    if case == "float64_target":
        target, err, match = target.double(), TypeError, "float32"
    elif case == "int64_ids":
        idx, err, match = idx.long(), TypeError, "int32"
    elif case == "k_above_cap":
        idx = torch.zeros((1, soa_tail.K_MAX + 1, POINTS), dtype=torch.int32)
        match = "range"
    with pytest.raises(err, match=match):
        soa_tail._launch_cuda(target, idx, PARAMS)


GATE_FAULTS = ("none",) + cs.PLANE_FIT_OUTPUTS + ("nan",)


@pytest.mark.parametrize("fault", GATE_FAULTS)
def test_gates_catch_each_fault(fault):
    target, idx = battery("missing", 8, seed=2)
    twin = soa_tail._plane_fit_plain(target, idx, PARAMS)
    out = [t.clone() for t in soa_tail._plane_fit_plain(target, idx, PARAMS)]
    p = (3, 5)
    want = fault
    if fault in ("fit_ok", "plane_ok"):
        i = cs.PLANE_FIT_OUTPUTS.index(fault)
        out[i][p] = ~out[i][p]
    elif fault == "nan":
        out[0][p], want = float("nan"), "nox"
    elif fault != "none":
        # one unit in the last place
        t = out[cs.PLANE_FIT_OUTPUTS.index(fault)]
        t[p] = torch.nextafter(t[p], torch.tensor(np.inf))
    row = cs.plane_fit_gates(out, twin)
    assert row["points"] == 8 * POINTS
    if fault == "none":
        assert row["failed"] == [] and sum(row["differ"].values()) == 0
    else:
        assert row["failed"] == [want], row
        assert row["differ"][want] == 1
        assert row["shown"][want][0][0] == p[0] * POINTS + p[1]


def test_gates_see_a_zeros_sign():
    target, idx = battery("planar", 1)
    twin = soa_tail._plane_fit_plain(target, idx, PARAMS)
    out = [t.clone() for t in twin]
    twin[2][0, 0], out[2][0, 0] = 0.0, -0.0
    assert cs.plane_fit_gates(out, twin)["failed"] == ["noz"]


# --------------------------------------------------------------------------
# the card: the kernel against the twin
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cases(source, B, dev):
    """(target, idx) on the card, idx in the loop's layout."""
    if source == "battery":
        out = []
        for kind in KINDS:
            t, i = battery(kind, B, seed=5)
            out.append((t.to(dev), loop_layout(i.to(dev))))
        return out
    return [map_like(B, dev, seed=11, N={1: 5000, 8: 2000, 128: 400}[B])]


@pytest.mark.chip
@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("source", ("battery", "map_like"))
def test_kernel_matches_the_twin_on_the_card(cuda, source, B):
    before = soa_tail._plane_fit.launches
    rows = []
    for target, idx in _cases(source, B, cuda):
        assert not idx.is_contiguous()
        row = cs.plane_fit_gates(soa_tail._plane_fit(target, idx, PARAMS),
                                 soa_tail._plane_fit_plain(target, idx,
                                                           PARAMS))
        assert not row["failed"], row
        rows.append(row)
    torch.cuda.synchronize()
    assert soa_tail._plane_fit.launches - before == len(rows)
    if source == "map_like":
        # most points fit a thin plane; some have missing neighbours
        r = rows[0]
        assert r["plane_ok"] > 0.5 * r["points"]


@pytest.mark.chip
@pytest.mark.parametrize("B", LANES)
def test_one_launch_captured_and_replayed(cuda, B):
    world, idx = map_like(B, cuda, seed=3, N=500)
    held = {}

    def part():
        with graphs.mark("tail.planes"):
            held["out"] = soa_tail._plane_fit(world, idx, PARAMS)

    gr = graphs.Graphs("plane_fit", graphs.State(), {"step": part}, cuda)
    # one device operation: no copy, fill or contiguity kernel
    assert gr.nodes["step"] == 1
    assert gr.modules["step"] == [("tail.planes", 0, 1)]
    before = (soa_tail._plane_fit.launches,
              soa_tail._plane_fit.launches_replayed)
    for t in held["out"]:
        t.fill_(True if t.dtype == torch.bool else 7.0)
    gr("step")
    torch.cuda.synchronize()
    assert soa_tail._plane_fit.launches - before[0] == 1
    assert soa_tail._plane_fit.launches_replayed - before[1] == 1
    eager = soa_tail._plane_fit(world, idx, PARAMS)
    for got, want in zip(held["out"], eager):
        assert _equal(got, want)
