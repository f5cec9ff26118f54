"""What the harness hands the system under test (the PyTorch and CUDA
port, ``dcreg_tpu_torch``): its parameters built from a configuration's
numbers.  The port is imported inside the functions, after the harness's
look for a chip."""
from __future__ import annotations


def icp_params(icp: dict, **overrides):
    """The port's ``ICPParams`` from a configuration's ``icp`` group."""
    from dcreg_tpu_torch.models.icp import ICPParams
    from dcreg_tpu_torch.ops.correspondence import CorrespondenceParams
    from dcreg_tpu_torch.ops.degeneracy import DegeneracyThresholds
    flat = {k: v for k, v in icp.items() if k not in ("corr", "thresholds")}
    return ICPParams(corr=CorrespondenceParams(**icp["corr"]),
                     thresholds=DegeneracyThresholds(**icp["thresholds"]),
                     **flat, **overrides)


def method(names):
    """(DetectionMethod, HandlingMethod) from their names."""
    from dcreg_tpu_torch.ops.degeneracy import DetectionMethod, HandlingMethod
    return DetectionMethod[names[0]], HandlingMethod[names[1]]
