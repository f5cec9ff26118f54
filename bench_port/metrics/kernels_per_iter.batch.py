"""Device kernels per step of the batch in the traced
window, counted from the profiler's trace: the port's ops on the card
(correspondence, SoA tail, GN build, degeneracy, solvers, linalg, K1)."""


def read(ctx):
    tr, it = ctx["trace"], ctx["counts"]["iterations"]
    if not tr.kernels or not it:
        return None
    return len(tr.kernels) / it
