"""Port parity: target normal estimation (``ops/normals.py``) against
``dcreg_tpu.ops.normals.estimate_normals`` on the same clouds, on the
CPU, k 5 (XICP) and 30 (O3D), PCL's single-pass covariance and the
centred one, f32 and f64.

Stated tolerances:
- neighbour ids: the same k-NN as the JAX module's (f64: the port's
  expansion path; f32: K2's twin against the XLA path's re-ranked
  candidates), so every normal comes from the same neighbours;
- f64: normals within rtol 1e-9, atol 1e-12 (the float32 single-pass
  covariance, noise included, is bit-equal to the JAX module's on the
  CPU, so only the f64 eigensolve's summation order differs);
- f32: normals within atol 1e-5, the float32 Jacobi eigensolve's
  rounding under XLA's fused multiply-adds (measured: 1.3e-6 at most).
"""
import numpy as np
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from chip_smoke import synthetic_cylinder
from dcreg_tpu.ops import knn as jknn
from dcreg_tpu.ops.normals import estimate_normals as j_normals
from dcreg_tpu_torch.ops import knn as tknn
from dcreg_tpu_torch.ops.normals import estimate_normals as t_normals

# LiDAR-like coordinates: a cylinder 10 m from the origin
CLOUD = synthetic_cylinder(3, 1200) + np.array([10.0, -5.0, 2.0], np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pcl_compat", [True, False])
@pytest.mark.parametrize("k", [5, 30])
def test_estimate_normals(k, pcl_compat, dtype):
    pts = CLOUD.astype(dtype)
    _, ij = jknn.knn(jnp.asarray(pts), jnp.asarray(pts), k=k, refine=2 * k)
    _, it = tknn.knn(torch.from_numpy(pts), torch.from_numpy(pts), k=k,
                     refine=2 * k)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    nj = np.asarray(j_normals(jnp.asarray(pts), k=k, pcl_compat=pcl_compat))
    nt = t_normals(torch.from_numpy(pts), k=k, pcl_compat=pcl_compat)
    assert nt.dtype == torch.from_numpy(pts).dtype
    if dtype == np.float64:
        np.testing.assert_allclose(nt.numpy(), nj, rtol=1e-9, atol=1e-12)
    else:
        np.testing.assert_allclose(nt.numpy(), nj, rtol=0, atol=1e-5)
    # oriented toward the origin, unit length
    assert bool((torch.sum(nt * -torch.from_numpy(pts), -1) >= 0).all())
    np.testing.assert_allclose(torch.linalg.norm(nt.double(), dim=-1),
                               1.0, atol=1e-5)


def test_estimate_normals_valid_mask_and_viewpoint():
    """Invalid targets never serve as neighbours; a viewpoint other than
    the origin flips the normals toward itself."""
    pts = CLOUD.astype(np.float64)
    valid = np.random.default_rng(4).uniform(size=len(pts)) > 0.2
    vp = np.array([10.0, 0.0, 8.0])
    nj = np.asarray(j_normals(jnp.asarray(pts), k=5, valid=jnp.asarray(valid),
                              viewpoint=jnp.asarray(vp)))
    nt = t_normals(torch.from_numpy(pts), k=5, valid=torch.from_numpy(valid),
                   viewpoint=torch.from_numpy(vp))
    np.testing.assert_allclose(nt.numpy(), nj, rtol=1e-9, atol=1e-12)
    assert bool((torch.sum(nt * (torch.from_numpy(vp) - torch.from_numpy(
        pts)), -1) >= 0).all())
