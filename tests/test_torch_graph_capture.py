"""The compiled loops of the port as CUDA graphs: what can be checked
without a card.

* A host-sync guard (a ``TorchDispatchMode``) fails on every op that
  reads the device from the host or builds a tensor from host data inside
  the prologue, step and epilogue of ``icp_batch_so3`` (reuse B = 1, map
  B = 2, BlockIndex B = 2) and of ``run_odometry_map``'s frame (DCReg fast
  and full, ME-SR, ME-TSVD, ME-TReg, FCN-SR, NONE): such an op cannot be
  captured.  The only exemption is the kernel boundary: the ops under
  ``block_knn_keys_plain``, K1's plain twin, which the card does not run
  (it launches K1).  The host's read of the done flag between steps is
  outside the parts.
* Stepping the in-place state reproduces, bit for bit, the loop as it
  was written before the split (Python-index history writes, out-of-place
  state), kept below as ``_seed_loop``; the map loop's frame reproduces a
  frame-by-frame chain of ``icp_batch_so3`` calls.
* ``graph=True`` on the CPU raises; the cache key follows the storage of
  the index and the target; the cache is a bounded LRU; a replay counts
  the kernel launches its capture tallied.
"""
import collections

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dcreg_tpu_torch import cuda_build, graphs
from dcreg_tpu_torch.models import icp_batch as tib
from dcreg_tpu_torch.models import odometry as todo
from dcreg_tpu_torch.models.icp import (ICPParams, covariance_from_H,
                                        empty_hist, telemetry_row)
from dcreg_tpu_torch.ops import block_knn as tk
from dcreg_tpu_torch.ops import block_sparse as tbs
from dcreg_tpu_torch.ops import se3
from dcreg_tpu_torch.ops.degeneracy import (DetectionMethod,
                                            HandlingMethod, analyze)
from dcreg_tpu_torch.scripts.run_corridor_experiment import METHODS

DCREG = (DetectionMethod.SCHUR_CONDITION_NUMBER,
         HandlingMethod.PRECONDITIONED_CG)


# --------------------------------------------------------------------------
# scenes (numpy, seeded)
# --------------------------------------------------------------------------

def _terrain(m=30_000, extent=20.0, seed=5):
    rng = np.random.default_rng(seed)
    g = int(m * 0.7)
    xy = rng.uniform(-extent, extent, (g, 2))
    z = 0.4 * np.sin(0.25 * xy[:, 0]) * np.cos(0.2 * xy[:, 1]) \
        + rng.normal(0, 0.01, g)
    # walls on the lines x = 5 k and y = 5 k
    w = m - g
    along = rng.uniform(-extent, extent, w)
    line = np.round(rng.uniform(-3, 3, w)) * 5.0 + rng.normal(0, 0.02, w)
    on_x = rng.random(w) < 0.5
    wall = np.column_stack([np.where(on_x, line, along),
                            np.where(on_x, along, line),
                            rng.uniform(0, 4, w)])
    world = np.vstack([np.column_stack([xy, z]), wall]).astype(np.float32)
    return world[tbs.kd_block_order(world, 128)]


def _scan(world, center, n, seed):
    rng = np.random.default_rng(seed)
    near = world[np.linalg.norm(world - center, axis=1) < 8.0]
    scan = (near[rng.choice(near.shape[0], n, replace=False)] - center
            + rng.normal(0, 0.003, (n, 3))).astype(np.float32)
    return scan[tbs.kd_block_order(scan, 128)]


def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


@pytest.fixture(scope="module")
def scene():
    world = _terrain()
    mindex = tbs.build_map_index(world, tb=128, sb=16, device="cpu")
    center = np.array([3.0, -2.5, 0.5])
    scan = _scan(world, center, 600, 1)
    rng = np.random.default_rng(3)
    # map mode, B = 2
    Rm = np.stack([_rot_z(a) for a in rng.uniform(-0.02, 0.02, 2)])
    tm = center[None] + rng.uniform(-0.15, 0.15, (2, 3))
    Sm, Gm, Pm = tib.estimate_map_capacities(
        mindex, scan, list(zip(Rm, tm)), 1.0)
    # reuse, B = 1
    R1 = np.eye(3)[None]
    t1 = center[None] + [0.05, -0.04, 0.02]
    r0, margin = 0.35, 0.4
    S1, G1, P1 = tib.estimate_map_capacities(mindex, scan, [(R1[0], t1[0])],
                                             r0 + margin)
    # BlockIndex mode, B = 2: the scan against its own neighbourhood
    near = world[np.linalg.norm(world - center, axis=1) < 6.0][:1500]
    blk = near[tbs.morton_argsort(near)].astype(np.float32)
    bindex = tbs.build_block_index(blk, tb=128, device="cpu")
    Rb = np.stack([_rot_z(a) for a in rng.uniform(-0.02, 0.02, 2)])
    tb = rng.uniform(-0.1, 0.1, (2, 3))
    Pb = tib.estimate_num_pairs(bindex, blk, list(zip(Rb, tb)), 1.0)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, 3] = center
    return {
        "world": world, "mindex": mindex, "scan": scan, "blk": blk,
        "bindex": bindex,
        "reuse_B1": dict(source=scan, target=world, R0s=R1, t0s=t1,
                         index=mindex, num_pairs=P1, num_supers=S1,
                         max_per_query=G1, initial_cull_radius=r0,
                         reuse_pair_list=margin, T_gt=T_gt,
                         params=ICPParams(max_iterations=12,
                                          full_telemetry=False)),
        "map_B2": dict(source=scan, target=world, R0s=Rm, t0s=tm,
                       index=mindex, num_pairs=Pm, num_supers=Sm,
                       max_per_query=Gm, initial_cull_radius=None,
                       reuse_pair_list=0.0, T_gt=T_gt,
                       params=ICPParams(max_iterations=12)),
        "block_B2": dict(source=blk, target=blk, R0s=Rb, t0s=tb,
                         index=bindex, num_pairs=Pb, num_supers=0,
                         max_per_query=0, initial_cull_radius=None,
                         reuse_pair_list=0.0, T_gt=None,
                         params=ICPParams(max_iterations=12)),
    }


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _loop(case, detection=DCREG[0], handling=DCREG[1], max_iterations=None):
    params = case["params"]
    if max_iterations is not None:
        params = params._replace(max_iterations=max_iterations)
    src = _f32(case["source"])
    loop = tib.BatchLoop(case["index"], _f32(case["target"]),
                         len(case["R0s"]), src.shape[0], detection, handling,
                         params, case["num_pairs"], case["num_supers"],
                         case["max_per_query"], case["initial_cull_radius"],
                         case["reuse_pair_list"], torch.device("cpu"))
    T_gt = torch.eye(4) if case["T_gt"] is None else _f32(case["T_gt"])
    state = graphs.State()
    loop.load(state, src, _f32(case["R0s"]), _f32(case["t0s"]), T_gt)
    return loop, state


def _run(case, **kw):
    return tib.icp_batch_so3(
        case["source"], case["target"], case["R0s"], case["t0s"], *DCREG,
        case["params"], case["index"], case["num_pairs"], T_gt=case["T_gt"],
        num_supers=case["num_supers"], max_per_query=case["max_per_query"],
        initial_cull_radius=case["initial_cull_radius"],
        reuse_pair_list=case["reuse_pair_list"], device="cpu", **kw)


# --------------------------------------------------------------------------
# the host-sync guard
# --------------------------------------------------------------------------

class HostSyncGuard(TorchDispatchMode):
    """Fails on an op that reads the device from the host (an item, a
    data-dependent shape, a comparison answered on the host) or builds a
    tensor from host data (a host-to-device copy on the card): none of
    them can be captured in a CUDA graph.  Ops under K1's plain twin, the
    kernel boundary, are exempt."""

    READS = ("aten._local_scalar_dense", "aten.nonzero",
             "aten.masked_select", "aten.equal", "aten.lift_fresh",
             "aten.lift_fresh_copy")

    def __init__(self):
        super().__init__()
        self.exempt = 0
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        self.seen[name] += 1
        if not self.exempt:
            bad = name in self.READS or "unique" in name
            if name in ("aten.index", "aten.index_put", "aten.index_put_"):
                bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                          for i in args[1] if i is not None)
            if name == "aten.repeat_interleave":
                bad = kwargs.get("output_size") is None
            if bad:
                raise AssertionError(f"host sync inside a compiled part: "
                                     f"{func}")
        return func(*args, **kwargs)


@pytest.fixture
def guard(monkeypatch):
    g = HostSyncGuard()
    plain = tk.K1.twin

    def exempt_plain(*args, **kwargs):
        g.exempt += 1
        try:
            return plain(*args, **kwargs)
        finally:
            g.exempt -= 1

    monkeypatch.setattr(tk.K1, "twin", exempt_plain)
    return g


def _warm_up(parts):
    """One eager run of every part, as ``graphs.Graphs`` runs them before
    capture: host-side constants cached at first use are made there."""
    for fn in parts.values():
        fn()


def _drive_guarded(guard, parts, state, max_iterations):
    """The compiled loop with each part under the guard."""
    with guard:
        parts["prologue"]()
    for it in range(max_iterations):
        if it and bool(state.done):             # the host's read, outside
            break
        with guard:
            parts["step"]()
    with guard:
        parts["epilogue"]()


@pytest.mark.parametrize("mode", ["reuse_B1", "map_B2", "block_B2"])
def test_batch_parts_do_not_read_the_host(scene, guard, mode):
    loop, state = _loop(scene[mode], max_iterations=3)
    _warm_up(graphs.parts(loop, state))
    _drive_guarded(guard, graphs.parts(loop, state), state, 3)
    assert guard.seen["aten.where"] > 0
    assert int(state.it) >= 1


MAP_METHODS = [("DCReg-fast", *DCREG, True)] + [
    (name, DetectionMethod[d], HandlingMethod[h], False)
    for name, d, h in METHODS]


def _map_inputs(scene, n_frames=2):
    world = scene["world"]
    poses = []
    for i in range(-2, n_frames):
        T = np.eye(4)
        T[:3, :3] = _rot_z(0.2 + 0.02 * i)
        T[:3, 3] = [2.0 + 0.2 * i, -2.5 + 0.05 * i, 0.5]
        poses.append(T)
    frames = []
    rng = np.random.default_rng(8)
    for T in poses[2:]:
        near = world[np.linalg.norm(world - T[:3, 3], axis=1) < 8.0]
        sel = near[rng.choice(near.shape[0], 500, replace=False)]
        frames.append((sel - T[:3, 3]) @ T[:3, :3]
                      + rng.normal(0, 0.003, (500, 3)))
    frames = todo.prepare_frames(np.asarray(frames, np.float32))
    r0, margin = 0.25, 0.2
    caps = todo.estimate_odometry_capacities(
        scene["mindex"], frames, np.asarray(poses[2:]), r0 + margin,
        slot_margin=1.6, sup_margin=4)
    return dict(frames=frames, T0=poses[1], T_prev=poses[0], caps=caps,
                r0=r0, margin=margin)


@pytest.mark.parametrize("name,det,hand,fast", MAP_METHODS,
                         ids=[m[0] for m in MAP_METHODS])
def test_map_frame_does_not_read_the_host(scene, guard, name, det, hand,
                                          fast):
    inp = _map_inputs(scene)
    S, G, P = inp["caps"]
    params = ICPParams(max_iterations=3, full_telemetry=False)
    frames = _f32(inp["frames"])
    loop = tib.BatchLoop(scene["mindex"], _f32(scene["world"]), 1,
                         frames.shape[1], det, hand, params, P, S, G,
                         inp["r0"], inp["margin"], torch.device("cpu"))
    mloop = todo.MapLoop(loop, True, fast, todo.ROW_BLOCK)
    state = graphs.State()
    mloop.load(state, frames[0], _f32(inp["T0"]), _f32(inp["T_prev"]))
    parts = graphs.parts(mloop, state)
    _warm_up(parts)
    mloop.load(state, frames[0], _f32(inp["T0"]), _f32(inp["T_prev"]))
    for f in range(frames.shape[0]):
        if f:
            state.put("src", frames[f])
        _drive_guarded(guard, parts, state, params.max_iterations)
    assert int(state.f) == frames.shape[0]


# --------------------------------------------------------------------------
# bit for bit against the loop before the split
# --------------------------------------------------------------------------

def _seed_loop(case):
    """``icp_batch_so3``'s loop as written before the split: the same
    iteration (``BatchLoop.iterate``), the history written at the Python
    index ``it``, the state rebound out of place each iteration."""
    loop, S = _loop(case)
    loop.prologue(S)
    params = case["params"]
    I = params.max_iterations
    B = loop.B
    Rs, ts = S.R0, S.t0
    conv = torch.zeros(B, dtype=torch.bool)
    abt = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    hist = empty_hist(I, torch.float32, lead=(B,))
    ovf = S.ovf.clone()
    r_cull = torch.full((B, loop.nq), loop.r0)
    cum_move = torch.zeros(B)
    for it in range(I):
        if bool(torch.all(conv | abt)):
            break
        active = ~(conv | abt)
        sysm, dx, abort_now, overflow, d5bm = loop.iterate(S, Rs, ts, r_cull,
                                                           active)
        abort_now = abort_now & active

        def put(dst, val):
            a = active.reshape((B,) + (1,) * (val.ndim - 1))
            dst[:, it] = torch.where(a, val, dst[:, it])

        put(hist.H, sysm.H)
        put(hist.rmse, sysm.rmse)
        put(hist.fitness, sysm.fitness)
        put(hist.num_valid, sysm.num_valid.to(torch.int32))
        if params.full_telemetry:
            put(hist.R, Rs)
            put(hist.t, ts)
            put(hist.g, sysm.g)
            put(hist.dx, dx)
            put(hist.objective, sysm.objective)
        Rn, tn = se3.boxplus(Rs, ts, dx)
        upd = active & ~abort_now
        Rs = torch.where(upd[:, None, None], Rn, Rs)
        ts = torch.where(upd[:, None], tn, ts)
        n_rot = torch.linalg.norm(dx[:, :3], dim=1)
        n_trans = torch.linalg.norm(dx[:, 3:], dim=1)
        step_conv = (n_rot < params.convergence_thresh_rot) & \
            (n_trans < params.convergence_thresh_trans) & ~abort_now
        conv = conv | (active & step_conv)
        abt = abt | abort_now
        iters = torch.where(active, it + 1, iters).to(torch.int32)
        move = n_rot * S.pmax + n_trans
        r_new = torch.clamp(d5bm + (1.05 * move + 0.01)[:, None],
                            max=loop.radius)
        r_cull = torch.where(active[:, None], r_new, r_cull)
        cum_move = cum_move + torch.where(active, move, 0.0)
        ovf = torch.maximum(ovf, overflow)
    if loop.reuse:
        ovf = ovf + torch.sum((2.0 * cum_move > loop.reuse_pair_list)
                              .to(torch.int64))
    last = torch.clamp(iters - 1, min=0).long()
    lane = torch.arange(B)
    return dict(R=Rs, t=ts, converged=conv, aborted=abt, iterations=iters,
                pair_overflow=ovf, H_last=hist.H[lane, last],
                rmse=hist.rmse[lane, last],
                fitness=hist.fitness[lane, last],
                num_valid=hist.num_valid[lane, last], hist=hist)


@pytest.mark.parametrize("mode", ["reuse_B1", "map_B2", "block_B2"])
def test_stepped_state_matches_the_seed_loop(scene, mode):
    case = scene[mode]
    ref = _seed_loop(case)
    out = _run(case)
    for name in ("R", "t", "converged", "aborted", "iterations",
                 "pair_overflow", "H_last", "rmse", "fitness", "num_valid"):
        assert torch.equal(getattr(out, name), ref[name]), name
    assert bool(out.converged.all())
    assert int(out.iterations.min()) >= 2
    # the whole history, through the telemetry pass, and the covariance
    params = case["params"]
    if params.full_telemetry:
        T_gt = _f32(case["T_gt"]) if case["T_gt"] is not None \
            else torch.eye(4)
        executed = torch.arange(params.max_iterations)[None] \
            < ref["iterations"][:, None]
        log = telemetry_row(ref["hist"], executed, *DCREG, params.thresholds,
                            params.min_effective_points, T_gt)
        for name in log._fields:
            _same(getattr(out.log, name), getattr(log, name), name)
        _same(out.covariance, covariance_from_H(
            ref["H_last"], ref["converged"], torch.float32), "covariance")


def _same(a, b, name):
    """Bit-equal, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        assert torch.equal(a.isnan(), b.isnan()), name
        a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
    assert torch.equal(a, b), name


@pytest.mark.parametrize("fast,method", [(True, DCREG), (False, (
    DetectionMethod.FULL_EVD_MIN_EIGENVALUE,
    HandlingMethod.TRUNCATED_SVD))], ids=["DCReg-fast", "ME-TSVD"])
def test_map_frames_match_a_chain_of_registrations(scene, fast, method):
    inp = _map_inputs(scene, n_frames=3)
    S, G, P = inp["caps"]
    params = ICPParams(full_telemetry=False)
    common = dict(num_supers=S, max_per_query=G, initial_cull_radius=inp["r0"],
                  reuse_pair_list=inp["margin"], device="cpu")
    out = todo.run_odometry_map(
        inp["frames"], scene["mindex"], scene["world"], T0=inp["T0"],
        T_prev_init=inp["T_prev"], detection=method[0], handling=method[1],
        icp_params=params, num_supers=S, max_per_query=G, num_pairs=P,
        initial_cull_radius=inp["r0"], reuse_margin=inp["margin"],
        frame_analysis_fast=fast, device="cpu")
    # the frame chain as separate registrations
    T0, Tp = _f32(inp["T0"]), _f32(inp["T_prev"])
    R_prev, t_prev, R_prev2, t_prev2 = T0[:3, :3], T0[:3, 3], Tp[:3, :3], \
        Tp[:3, 3]
    for f in range(inp["frames"].shape[0]):
        R_pred, t_pred = todo._seed(R_prev, t_prev, R_prev2, t_prev2, True)
        r = tib.icp_batch_so3(inp["frames"][f], scene["world"], R_pred[None],
                              t_pred[None], *method, params, scene["mindex"],
                              P, **common)
        ana = analyze(r.H_last[0], method[0], params.thresholds,
                      fast=fast and method == DCREG)
        R, t = r.R[0], r.t[0]
        assert torch.equal(out.poses[f], se3.se3_matrix(R, t))
        assert int(out.iterations[f]) == int(r.iterations[0])
        assert int(out.pair_overflow[f]) == int(r.pair_overflow)
        for name in ("cond_schur_rot", "cond_schur_trans", "cond_full",
                     "degenerate_mask", "is_degenerate"):
            assert torch.equal(getattr(out, name)[f], getattr(ana, name))
        assert torch.equal(out.rmse[f], r.rmse[0])
        assert torch.equal(out.effective_points[f], r.num_valid[0])
        R_prev2, t_prev2, R_prev, t_prev = R_prev, t_prev, R, t
    assert bool(out.converged.all())


# --------------------------------------------------------------------------
# options, cache and launch accounting
# --------------------------------------------------------------------------

def test_graph_true_on_the_cpu_raises(scene):
    case = scene["block_B2"]
    with pytest.raises(ValueError, match="CUDA device"):
        _run(case, graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        todo.run_odometry_map(scene["scan"][None], scene["mindex"],
                              scene["world"], num_supers=2,
                              max_per_query=4, num_pairs=64, device="cpu",
                              graph=True)
    assert graphs.use_graphs(torch.device("cuda"), None) is True
    assert graphs.use_graphs(torch.device("cpu"), None) is False
    # graph=False is the eager path: the same bits
    a, b = _run(case), _run(case, graph=False)
    assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t)


def _clone_index(ix):
    if isinstance(ix, tbs.MapIndex):
        return tbs.MapIndex(block=_clone_index(ix.block),
                            sup_lo=ix.sup_lo.clone(), sup_hi=ix.sup_hi.clone(),
                            blk_lo_g=ix.blk_lo_g.clone(),
                            blk_hi_g=ix.blk_hi_g.clone(), sb=ix.sb,
                            num_supers=ix.num_supers)
    return tbs.BlockIndex(blocks=ix.blocks.clone(), valid=ix.valid.clone(),
                          lo=ix.lo.clone(), hi=ix.hi.clone(),
                          num_blocks=ix.num_blocks, num_points=ix.num_points,
                          tb=ix.tb)


@pytest.mark.parametrize("mode", ["reuse_B1", "block_B2"])
def test_cache_key_follows_the_storage_read_in_place(scene, mode):
    case = scene[mode]
    key = _loop(case)[0].key()
    assert _loop(case)[0].key() == key           # same storage, same key
    moved = dict(case, index=_clone_index(case["index"]))
    assert _loop(moved)[0].key() != key          # same shapes, new storage
    # one field of the index alone
    ix = case["index"]
    bi = ix.block if isinstance(ix, tbs.MapIndex) else ix
    shifted = tbs.BlockIndex(blocks=bi.blocks, valid=bi.valid,
                             lo=bi.lo.clone(), hi=bi.hi,
                             num_blocks=bi.num_blocks,
                             num_points=bi.num_points, tb=bi.tb)
    if isinstance(ix, tbs.MapIndex):
        shifted = tbs.MapIndex(block=shifted, sup_lo=ix.sup_lo,
                               sup_hi=ix.sup_hi, blk_lo_g=ix.blk_lo_g,
                               blk_hi_g=ix.blk_hi_g, sb=ix.sb,
                               num_supers=ix.num_supers)
    assert _loop(dict(case, index=shifted))[0].key() != key
    # the target, and a static
    target = _f32(case["target"])
    loop_a = tib.BatchLoop(case["index"], target, 1, 600, *DCREG,
                           case["params"], 64, 4, 8, None, 0.0,
                           torch.device("cpu"))
    loop_b = tib.BatchLoop(case["index"], target.clone(), 1, 600, *DCREG,
                           case["params"], 64, 4, 8, None, 0.0,
                           torch.device("cpu"))
    loop_c = tib.BatchLoop(case["index"], target, 1, 600, *DCREG,
                           case["params"], 64, 4, 8, 0.3, 0.0,
                           torch.device("cpu"))
    assert len({loop_a.key(), loop_b.key(), loop_c.key()}) == 3


def test_graph_cache_is_a_bounded_lru():
    cache = graphs.GraphCache(max_entries=2)
    loads = collections.Counter()
    built = []

    class Entry:
        def __init__(self, key, state):
            self.key, self.state, self.seconds = key, state, 0.5
            built.append(key)

    def lookup(key):
        return cache.lookup(key, lambda s: loads.update([key]),
                            lambda s: Entry(key, s))

    a = lookup("a")
    assert loads["a"] == 2                 # before the build and after it
    assert lookup("a") is a and loads["a"] == 3
    lookup("b")
    lookup("a")                            # a is now the most recent
    lookup("c")                            # evicts b
    assert len(cache) == 2 and built == ["a", "b", "c"]
    lookup("a")
    assert built == ["a", "b", "c"]
    lookup("b")
    assert built == ["a", "b", "c", "b"]
    assert cache.captures == 4 and cache.capture_seconds == 2.0


def test_replays_count_the_launches_their_capture_tallied():
    wrapper = cuda_build.Kernel("test", "test.cu", "test", [], twin=None,
                                on_card=None)
    tally = collections.Counter()
    graphs._RECORDING.append(tally)
    try:
        graphs.note_launch(wrapper)
        graphs.note_launch(wrapper, 10)
        graphs.note_launch(wrapper, 10)
    finally:
        graphs._RECORDING.pop()
    assert wrapper.launches == 0 and tally == {(wrapper, None): 1,
                                               (wrapper, 10): 2}

    class FakeGraph:
        replays = 0

        def replay(self):
            FakeGraph.replays += 1

    g = graphs.Graphs.__new__(graphs.Graphs)
    g.graphs, g.launches = {"step": FakeGraph()}, {"step": tally}
    g("step")
    g("step")
    assert FakeGraph.replays == 2
    assert wrapper.launches == 6 and wrapper.launches_by_kk == {10: 4}
    assert wrapper.launches_replayed == 6
    graphs.note_launch(wrapper, 10)        # outside a capture: counted
    assert wrapper.launches == 7 and wrapper.launches_by_kk == {10: 5}
    assert wrapper.launches_replayed == 6


def test_state_slots_keep_their_storage():
    s = graphs.State()
    x = torch.arange(3.0)
    s.put("x", x)
    ptr = s.x.data_ptr()
    assert ptr != x.data_ptr()             # a copy, not the caller's tensor
    s.put("x", torch.ones(3))
    assert s.x.data_ptr() == ptr and torch.equal(s.x, torch.ones(3))
    with pytest.raises(ValueError, match="slot 'x'"):
        s.put("x", torch.ones(4))
    s.put_row("rows", torch.tensor(1), torch.tensor([2.0, 3.0]), 4)
    assert torch.equal(s.rows, torch.tensor([[0, 0], [2.0, 3], [0, 0],
                                             [0, 0]]))
