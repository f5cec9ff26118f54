"""Spans, module marks and the host-read counter of the port's loops
(``dcreg_tpu_torch.tracing``, ``graphs.mark``, ``graphs.STATS``).

* Off, a span records nothing; inside ``tracing.record()`` spans nest
  under their parents; under ``torch.profiler`` they are host events
  labelled with their names and args.
* An eager ``run_odometry_map`` on the CPU reads the done flag once per
  ICP iteration but the first, plus the read that finds the frame done:
  ``iters - [iters == max_iterations]`` per frame.
* ``tracing.split_replays`` splits synthetic replays by a module table and
  leaves a replay whose operation count differs from its part's unsplit.
* ``graphs.mark`` outside a capture adds nothing to any table; under a
  capture its ranges follow the capture's operation count.  The card's
  own capture is checked by the one test marked ``chip``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch
from torch.profiler import ProfilerActivity, profile

from dcreg_tpu_torch import graphs, tracing
from dcreg_tpu_torch.models import odometry as todo
from dcreg_tpu_torch.models.icp import ICPParams
from dcreg_tpu_torch.ops import block_sparse as tbs


# --------------------------------------------------------------------------
# spans and the recorder
# --------------------------------------------------------------------------

def test_a_span_off_records_nothing():
    assert tracing._RECORDER is None
    assert tracing.span("odometry.call", call=0) is tracing._OFF
    with tracing.record() as rec:
        pass
    with tracing.span("graphs.bind"):
        pass
    assert rec.spans == [] and rec.replays == []


def test_spans_nest_under_their_parents_inside_record():
    with tracing.record() as rec:
        with tracing.span("odometry.call", call=7):
            with tracing.span("graphs.bind"):
                pass
            with tracing.span("graphs.done_read"):
                pass
        with tracing.span("odometry.call", call=8):
            pass
    names = [(s[0], s[1], s[4]) for s in rec.spans]
    assert names == [("odometry.call", -1, {"call": 7}),
                     ("graphs.bind", 0, {}), ("graphs.done_read", 0, {}),
                     ("odometry.call", -1, {"call": 8})]
    assert all(s[2] <= s[3] for s in rec.spans)
    assert rec.spans[0][2] <= rec.spans[1][2] <= rec.spans[1][3] \
        <= rec.spans[2][2] <= rec.spans[2][3] <= rec.spans[0][3]
    inner = rec.self_seconds("odometry.call", ("graphs.done_read",))
    assert inner == pytest.approx(
        rec.seconds("odometry.call")
        - (rec.spans[2][3] - rec.spans[2][2]) * 1e-9)
    assert rec.wall_s > 0 and tracing._RECORDER is None
    with tracing.record():
        with pytest.raises(RuntimeError, match="do not nest"):
            with tracing.record():
                pass


def test_spans_are_host_events_under_the_profiler():
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("odometry.call", call=3):
            with tracing.span("graphs.replay", part="step", graphs=1):
                x = x + 1
    host, dev = tracing.events(prof)
    spans = [h[0] for h in host if h[4]]
    assert spans == ["odometry.call(call=3)",
                     "graphs.replay(part=step, graphs=1)"]
    assert tracing.parse(spans[1]) == ("graphs.replay",
                                       {"part": "step", "graphs": "1"})
    assert tracing.parse("graphs.bind") == ("graphs.bind", {})
    assert dev == [] and tracing.idle_gaps(prof) == {}
    assert tracing.span("graphs.bind") is tracing._OFF


def test_replay_outside_record_only_replays():
    class G:
        n = 0

        def replay(self):
            G.n += 1

    tracing.replay(G(), part="step", graphs=0)
    with tracing.record() as rec:
        tracing.replay(G(), part="step", graphs=0)
    assert G.n == 2
    assert [s[0] for s in rec.spans] == ["graphs.replay"]
    assert rec.spans[0][4] == {"part": "step", "graphs": 0}
    # no card: no event pool, so the replay is counted as untimed
    assert rec.replays == [] and rec.untimed == 1


# --------------------------------------------------------------------------
# the host reads of an eager map loop
# --------------------------------------------------------------------------

def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


@pytest.fixture(scope="module")
def map_scene():
    rng = np.random.default_rng(4)
    g = 16_000
    xy = rng.uniform(-15.0, 15.0, (g, 2))
    z = 0.3 * np.sin(0.3 * xy[:, 0]) * np.cos(0.25 * xy[:, 1]) \
        + rng.normal(0, 0.01, g)
    w = 6_000
    along = rng.uniform(-15.0, 15.0, w)
    line = np.round(rng.uniform(-2, 2, w)) * 6.0 + rng.normal(0, 0.02, w)
    on_x = rng.random(w) < 0.5
    wall = np.column_stack([np.where(on_x, line, along),
                            np.where(on_x, along, line),
                            rng.uniform(0, 3, w)])
    world = np.vstack([np.column_stack([xy, z]), wall]).astype(np.float32)
    world = world[tbs.kd_block_order(world, 128)]
    mindex = tbs.build_map_index(world, tb=128, sb=16, device="cpu")
    poses = []
    for i in range(-2, 3):
        T = np.eye(4)
        T[:3, :3] = _rot_z(0.1 + 0.03 * i)
        T[:3, 3] = [1.0 + 0.3 * i, -1.0 + 0.1 * i, 0.5]
        poses.append(T)
    frames = []
    for T in poses[2:]:
        near = world[np.linalg.norm(world - T[:3, 3], axis=1) < 7.0]
        sel = near[rng.choice(near.shape[0], 400, replace=False)]
        frames.append((sel - T[:3, 3]) @ T[:3, :3]
                      + rng.normal(0, 0.003, (400, 3)))
    frames = todo.prepare_frames(np.asarray(frames, np.float32))
    r0, margin = 0.25, 0.2
    caps = todo.estimate_odometry_capacities(
        mindex, frames, np.asarray(poses[2:]), r0 + margin,
        slot_margin=1.6, sup_margin=4)
    return dict(world=world, mindex=mindex, frames=frames, poses=poses,
                caps=caps, r0=r0, margin=margin)


@pytest.mark.parametrize("max_iterations", [2, 12])
def test_host_reads_count_one_per_iteration_but_the_cap(map_scene,
                                                        max_iterations):
    sc = map_scene
    S, G, P = sc["caps"]
    before = graphs.STATS.host_reads
    with tracing.record() as rec:
        res = todo.run_odometry_map(
            sc["frames"], sc["mindex"], sc["world"], T0=sc["poses"][1],
            T_prev_init=sc["poses"][0],
            icp_params=ICPParams(max_iterations=max_iterations),
            num_supers=S, max_per_query=G, num_pairs=P,
            initial_cull_radius=sc["r0"], reuse_margin=sc["margin"],
            device="cpu")
    iters = res.iterations.tolist()
    reads = graphs.STATS.host_reads - before
    assert reads == sum(i - (i == max_iterations) for i in iters)
    assert all(1 <= i <= max_iterations for i in iters)
    if max_iterations == 2:
        assert max_iterations in iters      # the cap is reached
    else:
        assert max(iters) < max_iterations
    names = [s[0] for s in rec.spans]
    assert names.count("odometry.call") == 1 and rec.spans[0][1] == -1
    assert names.count("graphs.done_read") == reads
    assert names.count("graphs.bind") == names.count("odometry.results") \
        == 1
    # the parts ran eagerly: each mark is a span inside the call
    steps = sum(iters)
    for m in ("search", "tail.planes", "tail.system", "degeneracy",
              "solve"):
        assert names.count(m) == steps, m
    assert names.count("update") == 2 * steps
    assert names.count("graphs.replay") == 0 and rec.replays == []
    assert all(s[1] >= 0 for s in rec.spans[1:])


# --------------------------------------------------------------------------
# splitting replays by module
# --------------------------------------------------------------------------

def _synthetic_profile():
    """Host and device events of three replays of part "step" (one with
    an operation missing) and of an eager copy, on one stream."""
    host, dev = [], []
    t = 0
    corr = 100
    for ops in (4, 4, 3):
        host.append(("graphs.replay(part=step, graphs=5)", t, t + 50, 0,
                     True))
        host.append(("cudaGraphLaunch", t + 5, t + 45, corr, False))
        for i in range(ops):
            dev.append((f"kernel_{i}", t + 100 + 10 * i,
                        t + 100 + 10 * i + (i + 1), corr))
        t += 1000
        corr += 1
    host.append(("cudaMemcpyAsync", t, t + 5, corr, False))
    dev.append(("Memcpy DtoD", t + 10, t + 17, corr))
    host.sort(key=lambda h: h[1])
    dev.sort(key=lambda d: d[1])
    return host, dev


def test_module_times_split_replays_by_the_module_table():
    host, dev = _synthetic_profile()
    # ops 0-1 "search", op 2 unmarked, op 3 "solve" (nested in "search"
    # as opened: the innermost mark wins)
    configs = {5: SimpleNamespace(
        label="run_odometry_map", nodes={"step": 4},
        modules={"step": [("search", 0, 2), ("solve", 3, 4)]})}
    out = tracing.split_replays(host, dev, configs)
    step = out["parts"]["run_odometry_map.step"]
    assert step["replays"] == 2 and step["ops"] == 8
    mods = step["modules"]
    assert mods["search"] == {"seconds": pytest.approx(2 * 3e-9), "ops": 4}
    assert mods[tracing.UNMARKED] == {"seconds": pytest.approx(2 * 3e-9),
                                      "ops": 2}
    assert mods["solve"] == {"seconds": pytest.approx(2 * 4e-9), "ops": 2}
    assert step["seconds"] == pytest.approx(sum(m["seconds"]
                                                for m in mods.values()))
    # the replay with three operations is not guessed
    assert out["unattributed"] == {"replays": 1,
                                   "seconds": pytest.approx(6e-9), "ops": 3}
    assert out["eager"] == {"seconds": pytest.approx(7e-9), "ops": 1}
    assert out["device"]["ops"] == 12
    assert out["device"]["seconds"] == pytest.approx(
        step["seconds"] + out["unattributed"]["seconds"]
        + out["eager"]["seconds"])
    nested = tracing._op_modules(4, [("update", 0, 4), ("solve", 1, 3)])
    assert nested == ["update", "solve", "solve", "update"]


def test_a_replay_of_an_unknown_configuration_is_unattributed():
    host, dev = _synthetic_profile()
    out = tracing.split_replays(host, dev, {})
    assert out["parts"] == {}
    assert out["unattributed"]["replays"] == 3
    assert out["unattributed"]["ops"] == 11


# --------------------------------------------------------------------------
# module marks
# --------------------------------------------------------------------------

def test_a_mark_outside_a_capture_adds_nothing():
    configs = dict(tracing.GRAPHS)
    assert graphs._RECORDING == []
    with graphs.mark("search"):
        pass
    with tracing.record() as rec:
        with graphs.mark("solve"):
            pass
    assert graphs._RECORDING == [] and dict(tracing.GRAPHS) == configs
    assert [s[0] for s in rec.spans] == ["solve"]


def test_marks_record_the_ranges_a_capture_grew_by(monkeypatch):
    counts = iter([0, 3, 3, 4, 6, 7])
    monkeypatch.setattr(graphs.Capture, "ops", lambda self: next(counts))
    cap = graphs.Capture()
    graphs._RECORDING.append(cap)
    try:
        with graphs.mark("search"):
            pass
        with graphs.mark("update"):
            with graphs.mark("solve"):
                pass
    finally:
        graphs._RECORDING.pop()
    # in the order they opened: the inner "solve" after "update"
    assert cap.modules == [["search", 0, 3], ["update", 3, 7],
                           ["solve", 4, 6]]
    assert tracing._op_modules(8, cap.modules) == [
        "search"] * 3 + ["update", "solve", "solve", "update",
                         tracing.UNMARKED]


@pytest.mark.chip
def test_a_captured_part_splits_into_its_marks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    y = torch.zeros_like(x)

    def part():
        with graphs.mark("first"):
            y.copy_(x * 2.0 + 1.0)
        with graphs.mark("second"):
            y.mul_(torch.sigmoid(y))
            y.add_(x.sum())
        y.sub_(1.0)

    def capture():
        state = graphs.State()
        g = graphs.Graphs("test", state, {"step": part}, x.device)
        return g.nodes["step"], g.modules["step"]

    nodes, modules = capture()
    with tracing.record():
        traced = capture()
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = capture()
    assert traced == profiled == (nodes, modules)
    (n1, a1, b1), (n2, a2, b2) = modules
    assert (n1, n2) == ("first", "second")
    assert a1 == 0 < b1 == a2 < b2 < nodes
    # a configuration no one holds leaves the tracing registry
    g = graphs.Graphs("test", graphs.State(), {"step": part}, x.device)
    assert tracing.GRAPHS[g.serial] is g
    serial = g.serial
    del g
    assert serial not in tracing.GRAPHS
