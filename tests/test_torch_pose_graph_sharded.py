"""``models/pose_graph.assemble_sharded``: the normal system with the
edges sharded over the mesh's data axis, in one 4-rank gloo world (a
2 x 2 mesh, data = 2) started once for the module, against the JAX
package's ``assemble_sharded`` on a (2, 2) mesh of the conftest's
virtual CPU devices and against the unsharded ``_assemble`` of both
packages.  The rank processes run this file as a script (the block under
``__main__``) and import only torch, numpy and the port.  f64; H, g and
the cost within 1e-12 relative to their largest entry.
"""
import os
import sys

import numpy as np
import torch

from dcreg_tpu_torch.models import pose_graph as tpg
from dcreg_tpu_torch.parallel import make_mesh



def port_args(a):
    """(poses, edges, prior_idx, prior_T, prior_info) as CPU tensors."""
    edges = tpg.make_edges(a["i"], a["j"], a["Z"], info=a["info"],
                           valid=a["valid"], device="cpu")
    T = lambda x: torch.as_tensor(x)
    return (T(a["poses"]), edges, T(a["prior_idx"]).long(), T(a["prior_T"]),
            T(a["prior_info"]))


def rank_main(rank, world, init_method, workdir):
    from dcreg_tpu_torch.parallel.distributed import init_distributed
    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, backend="gloo")
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    H, g, cost = tpg.assemble_sharded(make_mesh(2, 2, device="cpu"),
                                      *port_args(inputs))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), H=H.numpy(),
             g=g.numpy(), cost=cost.numpy())
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    # a rank process stops here, before pytest and JAX are imported
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from dcreg_tpu.models import pose_graph as jpg  # noqa: E402
from dcreg_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from test_torch_parallel import World  # noqa: E402
from test_torch_pose_graph import _graph  # noqa: E402


def _inputs():
    """A drifting 10-pose chain with a closure, a duplicated and an
    invalid edge (12 edges), and two priors off their poses."""
    _, init, i, j, Z, info, valid = _graph()
    prior_T = init[[0, 5]].copy()
    prior_T[:, :3, 3] += [[0.01, -0.02, 0.005], [0.03, 0.0, -0.01]]
    return dict(poses=init, i=i, j=j, Z=Z, info=info, valid=valid,
                prior_idx=np.array([0, 5]), prior_T=prior_T,
                prior_info=np.stack([1e8 * np.eye(6), 3.0 * np.eye(6)]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("torch_pose_graph_world")
    np.savez(workdir / "inputs.npz", **_inputs())
    w = World(os.path.abspath(__file__), workdir)
    yield w
    w.close()


def _jax_args(a):
    edges = jpg.make_edges(a["i"], a["j"], jnp.asarray(a["Z"]),
                           info=jnp.asarray(a["info"]),
                           valid=jnp.asarray(a["valid"]))
    return (jnp.asarray(a["poses"]), edges, jnp.asarray(a["prior_idx"]),
            jnp.asarray(a["prior_T"]), jnp.asarray(a["prior_info"]))


def _close(got, want):
    for name, x, y in zip(("H", "g", "cost"), got, want):
        x, y = np.asarray(x), np.asarray(y)
        scale = max(np.abs(y).max(), 1e-300)
        assert np.abs(x - y).max() <= 1e-12 * scale, name


def _rank0(world):
    out = world.results()[0]
    return out["H"], out["g"], out["cost"]


def test_matches_jax_assemble_sharded(world):
    mesh = jax_make_mesh(2, 2)
    # traced once: op by op, shard_map dispatches every op to each device
    want = jax.jit(lambda *a: jpg.assemble_sharded(mesh, *a))(
        *_jax_args(_inputs()))
    _close(_rank0(world), want)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_matches_unsharded_assemble(world, which):
    a = _inputs()
    want = (jax.jit(jpg._assemble)(*_jax_args(a)) if which == "jax"
            else tpg._assemble(*port_args(a)))
    _close(_rank0(world), want)


def test_prior_system_matches_jax():
    a = _inputs()
    poses, _, pi, pT, pinf = port_args(a)
    jposes, _, jpi, jpT, jpinf = _jax_args(a)
    _close(tpg._prior_system(poses, pi, pT, pinf),
           jax.jit(jpg._prior_system)(jposes, jpi, jpT, jpinf))


def test_ranks_bit_equal(world):
    ranks = world.results()
    for out in ranks[1:]:
        for key in ("H", "g", "cost"):
            assert np.array_equal(out[key], ranks[0][key]), key
