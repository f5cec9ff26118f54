"""Device kernels per step replay of the fleet's ticks in the traced
window (the prologue's and epilogue's included), counted from the
profiler's trace: the port's ops on the card (correspondence, SoA tail,
GN build, degeneracy, solvers, linalg, K1) for all lanes at once.
Moves ``frame_ms``."""


def read(ctx):
    tr, steps = ctx["trace"], ctx["counts"].get("steps")
    if not tr.kernels or not steps:
        return None
    return len(tr.kernels) / steps
