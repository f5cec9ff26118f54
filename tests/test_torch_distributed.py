"""``dcreg_tpu_torch.parallel.distributed``: the process-group set-up and
the host-aware mesh, in one 4-rank gloo world of two 'hosts' of two ranks
(LOCAL_WORLD_SIZE=2), started once for the module.  Its rank processes
run this file as a script (the block under ``__main__``), import only
torch, numpy and the port, and run one sharded registration, held
against the JAX package's single-process engine (as
tests/test_distributed.py does).  f64.
"""
import os
import sys

import numpy as np
import torch

from dcreg_tpu_torch import convert
from dcreg_tpu_torch.models.icp import ICPParams
from dcreg_tpu_torch.ops.degeneracy import DetectionMethod, HandlingMethod
from dcreg_tpu_torch.parallel import (make_mesh, shard_points,
                                      sharded_icp_register)
from dcreg_tpu_torch.parallel.distributed import (init_distributed,
                                                  make_host_mesh)

POSE = [0.01, -0.02, 0.03, 0.05, -0.04, 0.06]


def register(mesh, src, tgt, R0, t0, **kw):
    sp, sv = shard_points(src, mesh.shape["data"])
    tp, tv = shard_points(tgt, mesh.shape["map"], block=32)
    return convert.sharded_result_to_numpy(sharded_icp_register(
        mesh, sp, tp, R0, t0, DetectionMethod.SCHUR_CONDITION_NUMBER,
        HandlingMethod.PRECONDITIONED_CG, ICPParams(max_iterations=8),
        source_valid=sv, target_valid=tv, **kw))


def rank_main(rank, world, init_method, workdir):
    torch.set_num_threads(1)
    out = {"first": init_distributed(init_method, world, rank,
                                     backend="gloo"),
           # a second call is benign and answers for the live world
           "again": init_distributed(init_method, world, rank,
                                     backend="gloo")}
    mesh = make_host_mesh(map_per_host=2, device="cpu")
    local = int(os.environ["LOCAL_WORLD_SIZE"])
    out["shape"] = [mesh.shape["data"], mesh.shape["map"]]
    out["hosts"] = mesh.ranks // local
    out["default_shape"] = list(make_host_mesh(device="cpu").shape.values())
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    res = register(mesh, *(inputs[f] for f in ("src", "tgt", "R0", "t0")))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out, **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    # a rank process stops here, before pytest and JAX are imported
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from dcreg_tpu.models.icp import (  # noqa: E402
    ICPParams as JICPParams, icp_point_to_plane_so3)
from dcreg_tpu.ops.degeneracy import (  # noqa: E402
    DetectionMethod as JDet, HandlingMethod as JHand)
from test_torch_parallel import World, random_scene  # noqa: E402


def _inputs():
    from dcreg_tpu_torch.ops import se3
    src, tgt = random_scene()
    R0 = se3.euler_zyx_to_rot(*torch.tensor(POSE[:3], dtype=torch.float64))
    return src, tgt, R0.numpy(), np.array(POSE[3:])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("torch_distributed_world")
    src, tgt, R0, t0 = _inputs()
    np.savez(workdir / "inputs.npz", src=src, tgt=tgt, R0=R0, t0=t0)
    w = World(os.path.abspath(__file__), workdir,
              env={"LOCAL_WORLD_SIZE": "2"})
    yield w
    w.close()


@pytest.fixture(scope="module")
def single_process():
    """JAX's single-process engine on the same inputs (no telemetry
    pass: the pose and the iterations are what is compared)."""
    src, tgt, R0, t0 = _inputs()
    ref = icp_point_to_plane_so3(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(R0),
        jnp.asarray(t0), JDet.SCHUR_CONDITION_NUMBER,
        JHand.PRECONDITIONED_CG,
        JICPParams(max_iterations=8, full_telemetry=False))
    return {f: np.asarray(getattr(ref, f))
            for f in ("R", "t", "iterations", "converged")}


def test_init_distributed_reinit(world):
    for out in world.results():
        assert bool(out["first"]) and bool(out["again"])


def test_make_host_mesh_rows(world):
    """The map axis stays inside a host: each data row is one host."""
    for out in world.results():
        assert out["shape"].tolist() == [2, 2]
        assert out["hosts"].tolist() == [[0, 0], [1, 1]]
        # map_per_host defaults to the largest of {3, 2} dividing 2
        assert out["default_shape"].tolist() == [2, 2]


def test_registration_matches_single_process(world, single_process):
    out = world.results()[0]
    ref = single_process
    assert int(out["block_overflow"]) == 0
    assert bool(out["converged"]) and bool(ref["converged"])
    np.testing.assert_allclose(out["t"], ref["t"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(out["R"], ref["R"], rtol=0, atol=1e-8)
    assert int(out["iterations"]) == int(ref["iterations"])


def test_ranks_bit_equal(world):
    ranks = world.results()
    for out in ranks[1:]:
        for key, v in ranks[0].items():
            assert np.array_equal(out[key], v, equal_nan=True), key


def test_lone_process_world(monkeypatch, single_process):
    """With no address and no torchrun environment, init_distributed
    makes a one-rank world in process; a 1 x 1 mesh registers as the JAX
    engine does (its one map shard holds 32 blocks; the 2 x 2 mesh's
    hold 16, the default ``num_blocks``)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not torch.distributed.is_initialized()
    try:
        assert init_distributed(backend="gloo") is False
        assert init_distributed() is False
        assert torch.distributed.get_world_size() == 1
        out = register(make_mesh(1, 1, device="cpu"), *_inputs(),
                       num_blocks=32)
    finally:
        torch.distributed.destroy_process_group()
    assert int(out["block_overflow"]) == 0
    np.testing.assert_allclose(out["t"], single_process["t"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out["R"], single_process["R"], rtol=0,
                               atol=1e-8)
    assert int(out["iterations"]) == int(single_process["iterations"])
