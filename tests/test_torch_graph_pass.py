"""A pass of a captured loop on the card in one launch (``ops/loop_cond``,
the condition kernel between the steps) against the same pass part by
part, the host reading the loop's flag between steps (the kernel's plain
twin, ``graphs.host_pass``, taken with ``LOOP_COND.through_the_twin()``).
Both replay the same captured parts in the same order, so iterations,
poses and every output field must be bit-equal (NaN where the other is
NaN), and a pass on the card reads nothing on the host.

The scene is ``chip_smoke.py``'s at 2,400,000 points over a square of
side 80 m (the 53M-point map's density; the 128 frames' S-curve runs
about 28 m), its S-curve from seed 7 and scans of 700 points.  Cases:
the B = 1 map loop over the 128 frames; an 8-lane fleet tick (frames 0,
16, ..., 112); a ragged tick of 32 lanes (frames 0, 4, ..., 124, counts
drawn from 150 to 700); a Monte-Carlo batch of 32 poses around frame 0;
the map loop with a cap of 2 steps (frames at the cap) and with
thresholds every first step meets.  The CPU tests of the pass's split,
counters and routing are in ``test_torch_tracing.py``.

The ``chip`` cases run on the card (no JAX there; the tests' conftest
imports it):

    python3 -m pytest -q -p no:cacheprovider --noconftest -m chip \\
        tests/test_torch_graph_pass.py
"""
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

import chip_smoke as cs
from dcreg_tpu_torch import graphs
from dcreg_tpu_torch.models import odometry as todo
from dcreg_tpu_torch.models.icp import ICPParams
from dcreg_tpu_torch.models.icp_batch import (estimate_map_capacities,
                                              icp_batch_so3)
from dcreg_tpu_torch.ops import block_knn as tk
from dcreg_tpu_torch.ops import block_sparse as tbs
from dcreg_tpu_torch.ops import loop_cond, soa_tail
from dcreg_tpu_torch.ops.degeneracy import DetectionMethod, HandlingMethod

MAP_POINTS, EXTENT, SEED, SCAN_POINTS, FRAMES = 2_400_000, 40.0, 7, 700, 128
R0, MARGIN, MC_R0 = 0.18, 0.12, 0.25
LOOP_COND = loop_cond.LOOP_COND


@pytest.fixture(scope="module")
def sc():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = cs.synthetic_map(MAP_POINTS, EXTENT, SEED) \
        + np.array([0.0, 0.0, 9.0], np.float32)
    world = world[tbs.kd_block_order(world, 128)]
    T_pre2, T_pre1, gt = cs.trajectory(EXTENT, FRAMES)
    frames, _ = cs.scans(world, gt, SCAN_POINTS,
                         np.random.default_rng(SEED + 4))
    frames_s = todo.prepare_frames(frames)
    mindex = tbs.build_map_index(world, tb=128, sb=64, device="cuda")
    caps = todo.estimate_odometry_capacities(
        mindex, frames_s, gt, R0 + MARGIN, margin=1.25, slot_margin=1.6,
        sup_margin=4)
    return dict(world_t=torch.as_tensor(world, device="cuda"),
                frames_s=frames_s, gt=gt, mindex=mindex, caps=caps,
                known=np.concatenate([[T_pre2, T_pre1], gt]))


def common(sc):
    S, G, P = sc["caps"]
    return dict(num_supers=S, max_per_query=G, num_pairs=P,
                initial_cull_radius=R0, reuse_margin=MARGIN, device="cuda")


def on_card_and_twin(call):
    """(the pass on the card, the pass part by part, the launches the
    first counted, the host reads of each, graph launches and passes of
    the first): ``call`` runs once before, so both replay."""
    call()
    tally, passes = cs.Tally(), cs.Passes()
    card = call()
    counts = passes.since()
    launches = {k.label: (tally.launches(k), tally.replayed(k))
                for k in (tk.K1, soa_tail.PLANE_FIT, LOOP_COND)}
    reads = graphs.STATS.host_reads
    with LOOP_COND.through_the_twin():
        twin = call()
    torch.cuda.synchronize()
    return card, twin, launches, counts, graphs.STATS.host_reads - reads


def check(card, twin, launches, counts, twin_reads, passes, steps):
    assert cs.bit_equal(card, twin)
    assert counts == {"graph_launches": passes, "device_passes": passes,
                      "host_reads": 0}
    # one K1, plane_fit and condition launch per step, all from replays
    assert all(v == (steps, steps) for v in launches.values()), launches
    assert twin_reads > 0


def map_loop(sc, n=FRAMES, **params):
    return lambda: todo.run_odometry_map(
        sc["frames_s"][:n], sc["mindex"], sc["world_t"], T0=sc["known"][1],
        T_prev_init=sc["known"][0], icp_params=ICPParams(**params),
        **common(sc))


@pytest.mark.chip
def test_map_loop_pass_matches_per_part_replays(sc):
    card, twin, launches, counts, reads = on_card_and_twin(map_loop(sc))
    steps = int(card.iterations.sum())
    check(card, twin, launches, counts, reads, FRAMES, steps)
    # the twin reads before every step but the first, and once to stop
    assert reads == sum(i - (i == 30) for i in card.iterations.tolist())
    assert bool(card.converged.all())


@pytest.mark.chip
@pytest.mark.parametrize("params,iters", [
    (dict(max_iterations=2), {2}),
    (dict(convergence_thresh_trans=1.0, convergence_thresh_rot=1.0), {1})])
def test_a_pass_at_the_cap_and_one_done_at_its_first_step(sc, params,
                                                         iters):
    n = 16
    card, twin, launches, counts, reads = on_card_and_twin(
        map_loop(sc, n, **params))
    check(card, twin, launches, counts, reads, n,
          int(card.iterations.sum()))
    assert set(card.iterations.tolist()) == iters


def fleet_tick(sc, lanes, counts=None):
    known = torch.as_tensor(sc["known"], dtype=torch.float32, device="cuda")
    scans = np.stack([sc["frames_s"][f] for f in lanes])
    if counts is not None:
        scans[np.arange(scans.shape[1])[None] >= counts[:, None]] = 0.0
    scans = torch.as_tensor(scans, device="cuda")
    return lambda: todo.run_odometry_fleet(
        scans, sc["mindex"], sc["world_t"], known[[f + 1 for f in lanes]],
        known[list(lanes)], counts=counts, **common(sc))


@pytest.mark.chip
def test_fleet_tick_pass_matches_per_part_replays(sc):
    card, twin, launches, counts, reads = on_card_and_twin(
        fleet_tick(sc, range(0, FRAMES, 16)))
    steps = int(card.iterations.max())
    check(card, twin, launches, counts, reads, 1, steps)
    assert reads == steps                 # the twin reads after each step


@pytest.mark.chip
def test_ragged_tick_pass_matches_per_part_replays(sc):
    counts = np.random.default_rng(SEED).integers(150, SCAN_POINTS + 1, 32)
    card, twin, launches, counts_, reads = on_card_and_twin(
        fleet_tick(sc, range(0, FRAMES, 4), counts))
    check(card, twin, launches, counts_, reads, 1,
          int(card.iterations.max()))
    assert not bool(card.aborted.any())


@pytest.mark.chip
def test_monte_carlo_batch_pass_matches_per_part_replays(sc):
    gt = sc["gt"][0]
    nominal = np.array([np.deg2rad(0.1), np.deg2rad(0.1), np.deg2rad(0.3),
                        0.03, 0.05, 0.02])
    pert = nominal[None] * np.random.default_rng(SEED - 4).uniform(
        0.9, 1.1, (32, 6))
    R0s = np.stack([gt[:3, :3] @ cs.euler(*p[:3]) for p in pert])
    t0s = gt[:3, 3][None] + pert[:, 3:]
    S, G, P = estimate_map_capacities(
        sc["mindex"], sc["frames_s"][0], list(zip(R0s, t0s)), MC_R0 + 0.2,
        include_identity=False)
    card, twin, launches, counts, reads = on_card_and_twin(
        lambda: icp_batch_so3(
            sc["frames_s"][0], sc["world_t"], R0s, t0s,
            DetectionMethod.SCHUR_CONDITION_NUMBER,
            HandlingMethod.PRECONDITIONED_CG, ICPParams(), sc["mindex"], P,
            T_gt=gt, num_supers=S, max_per_query=G,
            initial_cull_radius=MC_R0, device="cuda"))
    steps = int(card.iterations.max())
    check(card, twin, launches, counts, reads, 1, steps)
    assert bool(card.converged.all())
