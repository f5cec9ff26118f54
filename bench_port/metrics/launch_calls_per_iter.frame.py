"""The host's kernel-launch calls (``cudaLaunchKernel`` and kin; the
``cudaGraphLaunch`` of a replay apart) per ICP iteration in the traced
window: what the per-call host path launches outside the graphs.  Moves
``frame_ms``."""

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")


def read(ctx):
    tr, it = ctx["trace"], ctx["counts"]["iterations"]
    if not tr.kernels or not it:
        return None
    return tr.count_host(LAUNCH_CALLS) / it
