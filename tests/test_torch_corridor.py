"""Port parity: the degenerate-corridor experiment
(``dcreg_tpu_torch/scripts/run_corridor_experiment.py``) against
``scripts/run_corridor_experiment.py`` and the recorded artifact in
``results/corridor_experiment/``, and every handler of its METHODS
through the localization loop ``run_odometry_map`` against dcreg_tpu's.

Stated tolerances, with the largest differences found:
  * ``corridor_world`` and ``make_frames`` at full size: bit-equal.
  * ``gt_trajectory`` written through ``save_tum`` against the recorded
    gt.tum: timestamps and translations equal to their 9 printed digits;
    quaternions within 1e-7 (found: 1e-9, one unit of the last printed
    digit).  Against the JAX script's trajectory built in float32, as
    the recorded run built it: translations bit-equal, rotations within
    one float32 ulp (found: 5 of 47 poses one ulp apart on the
    diagonal, XLA's float32 cos against PyTorch's).
  * The six methods on a reduced corridor (30 m, 6 frames of 600
    points, ``max_iterations=8``, ``frame_analysis_fast=False``) and
    DCReg with ``frame_analysis_fast=True``: per frame ``iterations``,
    ``converged``, ``pair_overflow``, ``is_degenerate``,
    ``degenerate_mask`` and ``effective_points`` equal; poses within
    1e-3 m (translation) and 1e-4 (rotation entries); ``cond_schur_*``
    and ``cond_full`` within rtol 1e-2; equal capacity estimates.
    Found: translations 1.9e-4 m at most (ME-TReg), rotations 2.3e-5,
    condition numbers 1.3e-3 relative.
    ME-SR and ME-TSVD are held on the frames before their divergence:
    ME-SR on frames 0-2 (at frame 3 JAX converges on its eighth and
    last iteration and the port does not), ME-TSVD on frames 0-1 (at
    frame 2 the port runs one iteration more).  Their later frames are
    held handler by handler: each is re-run by JAX from the JAX loop's
    seed (its final translation equal to the loop's), and fed JAX's own
    H and g of every iteration the port's analysis gives JAX's detection
    and mask and its solve JAX's step within 2e-5 of the step's largest
    entry plus 1e-7 (found: 6.1e-8 absolute at most).  Neither handler
    is at fault: ME-TSVD drops the two strongest directions and keeps
    the weakest (lambda ~5 of 9,000), so the float32 differences of the
    two packages' systems at equal poses grow into a different
    iteration count within a frame.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from dcreg_tpu.models.icp import ICPParams
from dcreg_tpu.models.odometry import (estimate_odometry_capacities,
                                       run_odometry_map)
from dcreg_tpu.ops.block_sparse import build_map_index
from dcreg_tpu.ops.degeneracy import DetectionMethod, HandlingMethod
from dcreg_tpu_torch.io.tum import save_tum
from dcreg_tpu_torch.scripts import run_corridor_experiment as rce

ROOT = pathlib.Path(__file__).resolve().parent.parent
RECORDED = ROOT / "results" / "corridor_experiment"


def jax_script():
    """``scripts/run_corridor_experiment.py`` imported by path (its JAX
    imports are inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_corridor_experiment",
        ROOT / "scripts" / "run_corridor_experiment.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_world_and_frames_bit_equal():
    js = jax_script()
    world = rce.corridor_world()
    assert world.shape == (108_318, 3)
    assert np.array_equal(world, js.corridor_world())
    _, _, gt = rce.gt_trajectory()
    frames = rce.make_frames(world, gt, n=rce.SCAN_POINTS)
    assert frames.shape == (45, 1500, 3)
    assert np.array_equal(frames, js.make_frames(world, gt, n=1500))
    assert (rce.METHODS, rce.REF_HEADER) == (js.METHODS, js.REF_HEADER)
    assert np.array_equal(rce.WORLD_OFFSET, js.WORLD_OFFSET)


def test_gt_trajectory_matches_recorded(tmp_path):
    T_pre2, T_pre1, gt = rce.gt_trajectory()
    path = tmp_path / "gt.tum"
    save_tum(str(path), np.arange(45) * 0.1, gt)
    ours = [line.split() for line in path.read_text().splitlines()]
    rec = [line.split()
           for line in (RECORDED / "gt.tum").read_text().splitlines()]
    assert len(ours) == len(rec) == 45
    for a, b in zip(ours, rec):
        assert a[:4] == b[:4]
        np.testing.assert_allclose(np.float64(a[4:]), np.float64(b[4:]),
                                   rtol=0, atol=1e-7)
    js = jax_script()
    with jax.enable_x64(False):        # the recorded run had no x64
        J_pre2, J_pre1, J_gt = js.gt_trajectory(45)
    for T, J in ((T_pre2, J_pre2), (T_pre1, J_pre1), (gt, J_gt)):
        assert np.array_equal(T[..., :3, 3], J[..., :3, 3])
        np.testing.assert_allclose(T[..., :3, :3], J[..., :3, :3],
                                   rtol=0, atol=2.0 ** -24)


# ---- the handlers through the localization loop --------------------------

# frames held for the methods that diverge between the two float32 loops
HELD_FRAMES = {"ME-SR": 3, "ME-TSVD": 2}
CASES = [(name, False) for name, _, _ in rce.METHODS] + [("DCReg", True)]


@pytest.fixture(scope="module")
def reduced():
    inp = rce.prepare("cpu", world=rce.corridor_world(length=30.0),
                      frames_n=6, scan_points=600)
    world_s = inp["world_s"].numpy()
    mj = build_map_index(world_s, tb=128, sb=16)
    caps = estimate_odometry_capacities(mj, inp["frames_s"], inp["gt"],
                                        rce.R_CULL0 + rce.REUSE_MARGIN)
    return inp, world_s, mj, caps


@pytest.fixture(scope="module")
def jax_loop(reduced):
    """JAX's ``run_odometry_map`` of one method on the reduced corridor,
    run once per (method, fast) in this module."""
    inp, world_s, mj, (S, G, P) = reduced
    runs = {}

    def run(name, fast):
        if (name, fast) not in runs:
            _, det, hand = next(m for m in rce.METHODS if m[0] == name)
            runs[name, fast] = run_odometry_map(
                jnp.asarray(inp["frames_s"]), mj, jnp.asarray(world_s),
                T0=jnp.asarray(inp["T_pre1"], jnp.float32),
                T_prev_init=jnp.asarray(inp["T_pre2"], jnp.float32),
                detection=DetectionMethod[det],
                handling=HandlingMethod[hand],
                icp_params=ICPParams(max_iterations=rce.MAX_ITERATIONS),
                num_supers=S, max_per_query=G, num_pairs=P,
                initial_cull_radius=rce.R_CULL0,
                reuse_margin=rce.REUSE_MARGIN, frame_analysis_fast=fast)
        return runs[name, fast]

    return run


def test_reduced_corridor_capacities(reduced):
    inp, _, _, caps = reduced
    assert caps == inp["caps"]


@pytest.mark.parametrize("name,fast", CASES,
                         ids=[f"{n}-{'fast' if f else 'full'}"
                              for n, f in CASES])
def test_methods_through_the_loop(reduced, jax_loop, name, fast):
    inp, world_s, mj, (S, G, P) = reduced
    _, det, hand = next(m for m in rce.METHODS if m[0] == name)
    rj = jax_loop(name, fast)
    rt = rce.run_odometry_map(
        inp["frames_s"], inp["mindex"], inp["world_s"], T0=inp["T_pre1"],
        T_prev_init=inp["T_pre2"], detection=det, handling=hand,
        icp_params=inp["params"], num_supers=S, max_per_query=G,
        num_pairs=P, initial_cull_radius=rce.R_CULL0,
        reuse_margin=rce.REUSE_MARGIN, frame_analysis_fast=fast,
        device="cpu")
    held = slice(0, HELD_FRAMES.get(name, 6))
    for f in ("iterations", "converged", "pair_overflow", "is_degenerate",
              "degenerate_mask", "effective_points"):
        assert np.array_equal(getattr(rt, f).numpy()[held],
                              np.asarray(getattr(rj, f))[held]), f
    pj, pt = np.asarray(rj.poses)[held], rt.poses.numpy()[held]
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], rtol=0,
                               atol=1e-4)
    for f in ("cond_schur_rot", "cond_schur_trans", "cond_full"):
        np.testing.assert_allclose(getattr(rt, f).numpy()[held],
                                   np.asarray(getattr(rj, f))[held],
                                   rtol=1e-2, err_msg=f)
    # the corridor's weak axis: every frame degenerate but for NONE
    assert bool(rt.is_degenerate[held].all()) == (name != "NONE")


@pytest.mark.parametrize("name", sorted(HELD_FRAMES))
def test_diverging_handlers_step_on_jax_systems(reduced, jax_loop, name):
    """The frames of ME-SR and ME-TSVD from where the two loops part to
    the last: each frame's registration re-run by JAX's ``icp_batch_so3``
    from the JAX loop's seed, with its per-iteration log, and every
    iteration's H and gradient fed to the port's ``analyze`` and
    ``solve``: detection and mask equal, the step within 2e-5 of its
    largest entry plus 1e-7 (a nineteenth of a float32 ulp at the
    corridor's 30 m coordinates).  Found: 6.1e-8 absolute at most,
    2.4e-4 relative on the smallest (6e-5) steps."""
    from dcreg_tpu.models.icp_batch import icp_batch_so3
    from dcreg_tpu.ops import se3 as jse3
    from dcreg_tpu_torch.ops import degeneracy as tdeg
    from dcreg_tpu_torch.ops import solvers as tsol
    import torch
    inp, world_s, mj, (S, G, P) = reduced
    _, det, hand = next(m for m in rce.METHODS if m[0] == name)
    poses = np.asarray(jax_loop(name, False).poses)
    before = [inp["T_pre2"].astype(np.float32),
              inp["T_pre1"].astype(np.float32), *poses]
    jprm = ICPParams(max_iterations=rce.MAX_ITERATIONS)
    tprm = inp["params"]
    common = dict(num_supers=S, max_per_query=G,
                  initial_cull_radius=rce.R_CULL0,
                  reuse_pair_list=rce.REUSE_MARGIN)
    for f in range(HELD_FRAMES[name], poses.shape[0]):
        (R2, t2), (R1, t1) = [(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]))
                              for T in before[f:f + 2]]
        # the JAX loop's constant-velocity seed
        Rs = jse3.orthonormalize(R1 @ (R2.T @ R1))
        ts = R1 @ (R2.T @ (t1 - t2)) + t1
        scan = inp["frames_s"][f]
        oj = icp_batch_so3(jnp.asarray(scan), jnp.asarray(world_s),
                           Rs[None], ts[None], DetectionMethod[det],
                           HandlingMethod[hand], jprm, mj, P, **common)
        np.testing.assert_allclose(np.asarray(oj.t)[0], poses[f][:3, 3],
                                   rtol=0, atol=1e-5)
        log = oj.log
        H, grad, dx = (np.asarray(log.H)[0], np.asarray(log.gradient)[0],
                       np.asarray(log.dx)[0])
        deg, mask = (np.asarray(log.is_degenerate)[0],
                     np.asarray(log.degenerate_mask)[0])
        for i in np.nonzero(np.asarray(log.executed)[0])[0]:
            Hi = torch.as_tensor(H[i].copy())
            ana = tdeg.analyze(Hi, tdeg.DetectionMethod[det],
                               tprm.thresholds)
            step, _ = tsol.solve(Hi, -torch.as_tensor(grad[i].copy()),
                                 tdeg.HandlingMethod[hand], ana,
                                 tprm.thresholds, telemetry=False)
            assert bool(ana.is_degenerate) == bool(deg[i]), (f, i)
            assert np.array_equal(ana.degenerate_mask.numpy(), mask[i])
            np.testing.assert_allclose(step.numpy(), dx[i], rtol=0,
                                       atol=2e-5 * np.abs(dx[i]).max()
                                       + 1e-7,
                                       err_msg=f"frame {f} iteration {i}")


def test_corridor_entry_points_need_a_card_or_cpu(monkeypatch, tmp_path):
    """``main`` and ``prepare`` run on cuda unless told device='cpu';
    with no card they raise before writing anything."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rce.main(str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rce.prepare(None, world=rce.corridor_world(length=30.0),
                    frames_n=2, scan_points=300)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        rce.main(str(tmp_path / "out"), device="cuda")
    inp = rce.prepare("cpu", world=rce.corridor_world(length=30.0),
                      frames_n=2, scan_points=300)
    assert inp["world_s"].device.type == "cpu"
