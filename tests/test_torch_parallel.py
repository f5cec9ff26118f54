"""Parity of ``dcreg_tpu_torch.parallel.sharded`` with
``dcreg_tpu.parallel.sharded``.

The mesh helpers and the local searches run in this process.  The
sharded engine runs in one 4-rank gloo world (a 2 x 2 mesh), started once
for the module: its rank processes run this file as a script (the block
under ``__main__``), import only torch, numpy and the port, and write
their results beside the inputs.  The JAX side runs on a (2, 2) mesh of
the conftest's virtual CPU devices.  f64 throughout.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from dcreg_tpu_torch import convert
from dcreg_tpu_torch.models.icp import ICPParams
from dcreg_tpu_torch.ops import se3
from dcreg_tpu_torch.ops.block_sparse import kd_block_order, morton_argsort
from dcreg_tpu_torch.ops.degeneracy import DetectionMethod, HandlingMethod
from dcreg_tpu_torch.parallel import sharded as ts

SMALL_POSE = [0.01, -0.02, 0.03, 0.05, -0.04, 0.06]
# name: (scene, max_iterations, pose, sharded_icp_register keywords)
CASES = {
    "dense": ("small", 8, SMALL_POSE, dict(block_cull=False)),
    "flat": ("small", 8, SMALL_POSE, dict(block_cull=True)),
    "two_level": ("wide", 8, SMALL_POSE,
                  dict(block_cull=True, num_blocks=64, super_size=4,
                       num_supers=16)),
    "midsize": ("midsize", 10, [0.004, -0.006, 0.01, 0.04, -0.05, 0.03],
                dict(block_cull=True, num_blocks=96, super_size=8,
                     num_supers=24)),
}


def random_scene(n=512, m=1024, seed=0):
    """A bumpy Morton-sorted surface and a random subset of it (the scene
    of tests/test_parallel.py)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-5, 5, (m, 2))
    z = 0.1 * np.sin(xy[:, 0]) * np.cos(xy[:, 1]) + rng.normal(0, 0.002, m)
    target = np.column_stack([xy, z])
    target = target[morton_argsort(target)]
    return target[rng.choice(m, n, replace=False)], target


def midsize_scene():
    """60k-point kd-ordered map and a 4,096-point disc scan of it."""
    rng = np.random.default_rng(12)
    m = 60_000
    xy = rng.uniform(-20, 20, (m, 2))
    z = 0.15 * np.sin(0.7 * xy[:, 0]) * np.cos(0.5 * xy[:, 1]) \
        + rng.normal(0, 0.003, m)
    target = np.column_stack([xy, z])
    target = target[kd_block_order(target, 32)]
    in_disc = np.sum((target[:, :2] - [7.0, 5.0]) ** 2, axis=1) < 36.0
    return target[in_disc][:4096], target


def case_inputs():
    """{case: (source, target, R0, t0)} as numpy f64."""
    scenes = {"small": random_scene(), "wide": random_scene(512, 4096, 3),
              "midsize": midsize_scene()}
    out = {}
    for name, (scene, _, pose, _) in CASES.items():
        R0 = se3.euler_zyx_to_rot(*torch.tensor(pose[:3], dtype=torch.float64))
        out[name] = (*scenes[scene], R0.numpy(), np.array(pose[3:]))
    return out


def port_register(mesh, name, src, tgt, R0, t0):
    _, iters, _, kw = CASES[name]
    sp, sv = ts.shard_points(src, mesh.shape["data"])
    tp, tv = ts.shard_points(tgt, mesh.shape["map"], block=32)
    return ts.sharded_icp_register(
        mesh, sp, tp, R0, t0, DetectionMethod.SCHUR_CONDITION_NUMBER,
        HandlingMethod.PRECONDITIONED_CG, ICPParams(max_iterations=iters),
        source_valid=sv, target_valid=tv, **kw)


def rank_main(rank, world, init_method, workdir):
    """One rank of the module's world: every case on the 2 x 2 mesh, the
    dense case once more on a mesh laid out over the ranks in reverse."""
    from dcreg_tpu_torch.parallel.distributed import init_distributed
    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, backend="gloo")
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    arrays = lambda name: [inputs[f"{name}.{f}"]
                           for f in ("src", "tgt", "R0", "t0")]
    mesh = ts.make_mesh(2, 2, device="cpu")
    out = {"coords": np.array(mesh.coords), "ranks": mesh.ranks}
    for name in CASES:
        res = port_register(mesh, name, *arrays(name))
        for f, v in convert.sharded_result_to_numpy(res).items():
            out[f"{name}.{f}"] = v
    rev = ts.make_mesh(2, 2, devices=[3, 2, 1, 0], device="cpu")
    out["rev.coords"] = np.array(rev.coords)
    for f, v in convert.sharded_result_to_numpy(
            port_register(rev, "dense", *arrays("dense"))).items():
        out[f"rev.{f}"] = v
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


class World:
    """``script`` running as ``world`` rank processes of one gloo world
    over localhost, each with the arguments (rank, world, init_method,
    workdir); it runs while the caller works on."""

    def __init__(self, script, workdir, world=4, env=None):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {**os.environ, **(env or {}), "PYTHONPATH": repo + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        self.workdir, self._out = workdir, None
        self.procs = [subprocess.Popen(
            [sys.executable, script, str(r), str(world),
             f"tcp://127.0.0.1:{port}", str(workdir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]

    def results(self, timeout=600):
        """Each rank's saved arrays; raises with the output of a rank
        that failed."""
        if self._out is None:
            logs = [p.communicate(timeout=timeout)[0] for p in self.procs]
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} failed ({p.returncode}):"
                                       f"\n{log[-4000:]}")
            self._out = [dict(np.load(os.path.join(self.workdir,
                                                   f"rank{r}.npz")))
                         for r in range(len(self.procs))]
        return self._out

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    # a rank process stops here, before pytest and JAX are imported
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from dcreg_tpu.models.icp import ICPParams as JICPParams  # noqa: E402
from dcreg_tpu.ops.degeneracy import (  # noqa: E402
    DetectionMethod as JDet, HandlingMethod as JHand)
from dcreg_tpu.parallel import sharded as js  # noqa: E402


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, World) of the module's 4-rank world."""
    workdir = tmp_path_factory.mktemp("torch_parallel_world")
    inputs = case_inputs()
    np.savez(workdir / "inputs.npz", **{
        f"{name}.{f}": a for name, arrays in inputs.items()
        for f, a in zip(("src", "tgt", "R0", "t0"), arrays)})
    w = World(os.path.abspath(__file__), workdir)
    yield inputs, w
    w.close()


def jax_register(name, src, tgt, R0, t0):
    _, iters, _, kw = CASES[name]
    mesh = js.make_mesh(2, 2)
    sp, sv = js.shard_points(jnp.asarray(src), 2)
    tp, tv = js.shard_points(jnp.asarray(tgt), 2, block=32)
    return convert.sharded_result_to_numpy(js.sharded_icp_register(
        mesh, sp, tp, jnp.asarray(R0), jnp.asarray(t0),
        JDet.SCHUR_CONDITION_NUMBER, JHand.PRECONDITIONED_CG,
        JICPParams(max_iterations=iters), source_valid=sv,
        target_valid=tv, **kw))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 9, 12, 16])
def test_factor_mesh(n):
    assert ts.factor_mesh(n) == js.factor_mesh(n)


@pytest.mark.parametrize("n,shards,block", [(5, 2, 1), (1, 3, 1),
                                            (100, 4, 32), (128, 2, 32),
                                            (1000, 3, 128)])
def test_pad_and_shard_points(n, shards, block):
    xyz = np.random.default_rng(n).normal(size=(n, 3))
    assert ts.pad_for_mesh(n, shards) == js.pad_for_mesh(n, shards)
    p, v = ts.shard_points(xyz, shards, block=block)
    jp, jv = js.shard_points(jnp.asarray(xyz), shards, block=block)
    assert np.array_equal(p.numpy(), np.asarray(jp))
    assert np.array_equal(v.numpy(), np.asarray(jv))


def test_smallest_f32_ties_to_the_lower_index():
    rng = np.random.default_rng(4)
    x = rng.integers(-4, 5, (64, 40)).astype(np.float32) * 0.25
    x[rng.random(x.shape) < 0.2] = np.inf
    x[0, :3] = [0.0, -0.0, 0.0]
    vals, idx = ts._smallest(torch.from_numpy(x), 7)
    ref = np.argsort(np.where(x == 0, 0.0, x), axis=1, kind="stable")[:, :7]
    assert np.array_equal(idx.numpy(), ref)
    assert np.array_equal(vals.numpy(), np.take_along_axis(x, ref, axis=1))


def _shard_blocks(target, valid, tb=32):
    blocks = target.reshape(-1, tb, 3)
    bval = valid.reshape(-1, tb)
    lo = np.min(np.where(bval[..., None], blocks, np.inf), axis=1)
    hi = np.max(np.where(bval[..., None], blocks, -np.inf), axis=1)
    return blocks, bval, lo, hi


def test_local_topk_dense():
    rng = np.random.default_rng(5)
    tgt = rng.uniform(-3, 3, (1000, 3))
    valid = rng.random(1000) > 0.1
    p_w = rng.uniform(-3, 3, (300, 3))
    d, c = ts._local_topk(torch.from_numpy(p_w), torch.from_numpy(tgt),
                          torch.from_numpy(valid), 5)
    jd, jc = jax.jit(js._local_topk, static_argnums=3)(
        jnp.asarray(p_w), jnp.asarray(tgt), jnp.asarray(valid), 5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-12)
    assert np.array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("sb,GS,G,overflows", [
    (0, 0, 96, False), (0, 0, 8, True), (4, 24, 96, False),
    (4, 16, 64, True), (4, 3, 8, True)])
def test_local_topk_culled(sb, GS, G, overflows):
    """Flat and two-level culls on one shard, with room for every
    relevant block and super (at most 82 and 23 here) and with too little
    (overflow counted)."""
    src, tgt = random_scene(2000, 4096, 7)
    valid = np.ones(4096, bool)
    valid[::37] = False
    tgt = np.where(valid[:, None], tgt, 1e6)
    p_w = src[morton_argsort(src)] + 0.01
    q_valid = np.ones(2000, bool)
    q_valid[5::50] = False
    args = (p_w, q_valid, *_shard_blocks(tgt, valid))
    d, c, ovf = ts._local_topk_culled(*map(torch.from_numpy, args), 1.0, 5,
                                      G, sb=sb, GS=GS)
    # traced once (op by op it takes seconds)
    jd, jc, jovf = jax.jit(js._local_topk_culled,
                           static_argnums=tuple(range(6, 11)))(
        *map(jnp.asarray, args), 1.0, 5, G, sb, GS)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-12)
    assert np.array_equal(c.numpy(), np.asarray(jc))
    assert int(ovf) == int(jovf)
    assert (int(ovf) > 0) == overflows


def test_two_level_caps_must_cover_num_blocks():
    src, tgt = random_scene(300, 1024, 8)
    args = (src, np.ones(300, bool), *_shard_blocks(tgt, np.ones(1024, bool)))
    with pytest.raises(ValueError, match="num_blocks"):
        ts._local_topk_culled(*map(torch.from_numpy, args), 1.0, 5, 16,
                              sb=4, GS=3)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_jax(world, name):
    inputs, w = world
    ref = jax_register(name, *inputs[name])    # while the ranks run
    got = {f: w.results()[0][f"{name}.{f}"] for f in ref}
    assert int(got["block_overflow"]) == 0 == int(ref["block_overflow"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["R"], ref["R"], rtol=0, atol=1e-8)
    assert int(got["iterations"]) == int(ref["iterations"])
    assert bool(got["converged"]) == bool(ref["converged"])
    assert int(got["effective_points"]) == int(ref["effective_points"])
    np.testing.assert_allclose(got["fitness"], ref["fitness"], rtol=1e-12)
    np.testing.assert_allclose(got["rmse"], ref["rmse"], rtol=1e-8)


def test_ranks_bit_equal(world):
    ranks = world[1].results()
    for r in ranks[1:]:
        for key, v in ranks[0].items():
            if "coords" not in key:
                assert np.array_equal(r[key], v, equal_nan=True), key


def test_mesh_layout_and_order(world):
    """Rank r sits at (r // 2, r % 2); a mesh over the ranks in reverse
    puts them elsewhere and gives the same registration."""
    ranks = world[1].results()
    for r, out in enumerate(ranks):
        assert out["coords"].tolist() == [r // 2, r % 2]
        assert out["ranks"].tolist() == [[0, 1], [2, 3]]
        assert out["rev.coords"].tolist() == [(3 - r) // 2, (3 - r) % 2]
        for f in ("R", "t", "iterations", "converged"):
            assert np.array_equal(out[f"rev.{f}"], out[f"dense.{f}"]), f
