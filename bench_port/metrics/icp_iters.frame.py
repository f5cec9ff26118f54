"""ICP iterations per frame over the traced window's frames (the port's
``MapOdometryResult.iterations``): moves ``frame_ms``."""


def read(ctx):
    return ctx["counts"].get("iters_per_frame")
