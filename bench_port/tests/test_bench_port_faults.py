"""A run with the timed path broken underneath comes out not correct:
the harness is driven on the CPU at a tiny size with the port patched so
that a registration step returns its state unchanged, a pose is altered
where the loop writes it, or half of a batch's lanes are left out."""
import pytest
import torch

from dcreg_tpu_torch.models import icp_batch
from dcreg_tpu_torch.ops import se3

from test_bench_port_data import run_tiny


def frozen_step(R, t, delta):
    """A step that returns the state unchanged."""
    return R, t


def altered_matrix(R, t):
    """The loop's written pose moved by 2 mrad and 1 cm about and along
    an oblique body axis."""
    axis = torch.tensor([0.3, 0.5, 0.81], dtype=R.dtype, device=R.device)
    axis = axis / axis.norm()
    w = 2e-3 * axis
    K = torch.zeros(3, 3, dtype=R.dtype, device=R.device)
    K[0, 1], K[0, 2], K[1, 2] = -w[2], w[1], -w[0]
    K = K - K.T
    return REAL_SE3_MATRIX(R @ torch.linalg.matrix_exp(K),
                           t + 0.01 * (R @ axis))


REAL_SE3_MATRIX = se3.se3_matrix
REAL_BATCH = icp_batch.icp_batch_so3


def half_batch(source, target, R0s, t0s, *args, **kwargs):
    """Only the first half of the lanes registered; the rest returned at
    their initial poses, as if done at once."""
    import torch
    B, h = R0s.shape[0], R0s.shape[0] // 2
    out = REAL_BATCH(source, target, R0s[:h], t0s[:h], *args, **kwargs)
    R0s, t0s = torch.as_tensor(R0s).to(out.R), torch.as_tensor(t0s).to(out.t)
    # the left-out lanes repeat lane 0's report: done, at their seeds
    pad = lambda x: torch.cat([x, x[:1].expand((B - h,) + x.shape[1:])])
    return out._replace(
        R=torch.cat([out.R, R0s[h:]]), t=torch.cat([out.t, t0s[h:]]),
        iterations=pad(out.iterations), aborted=pad(out.aborted),
        converged=pad(out.converged), H_last=pad(out.H_last),
        rmse=pad(out.rmse), fitness=pad(out.fitness),
        num_valid=pad(out.num_valid))


@pytest.mark.parametrize("workload", ["tmap.stream", "tcor.stream",
                                      "tmap.mc128"])
def test_sound_run_is_correct(tiny_root, workload):
    result, lines = run_tiny(tiny_root, workload)
    assert result["correct"], lines


@pytest.mark.parametrize("workload,target,name,fault", [
    ("tcor.stream", se3, "boxplus", frozen_step),
    ("tcor.stream", se3, "se3_matrix", altered_matrix),
    ("tmap.stream", se3, "boxplus", frozen_step),
    ("tmap.stream", se3, "se3_matrix", altered_matrix),
    ("tmap.mc128", icp_batch, "icp_batch_so3", half_batch),
])
def test_broken_path_is_not_correct(tiny_root, monkeypatch, workload,
                                    target, name, fault):
    monkeypatch.setattr(target, name, fault)
    result, lines = run_tiny(tiny_root, workload)
    assert not result["correct"], lines
