"""Device time of the mixed fleet's traced ticks per thousand valid
points: the busy time of the traced window (the union of the device's
operations, from the profiler's trace) over the points the ticks
registered, the sum of the ``points`` argument of their
``odometry.fleet_call`` spans (``models.odometry``, the sum of the
tick's ``counts``).  Set beside the spans' ``capacity``, it shows whether
a tick costs in proportion to its valid points or to its rows.  Moves
``frame_ms``.  A program whose span has no ``points`` gives nothing."""

SPAN = "odometry.fleet_call("


def points(name: str):
    """The ``points`` argument of a span's profiler label, or None."""
    for item in name[len(SPAN):].rstrip(")").split(", "):
        key, _, value = item.partition("=")
        if key == "points":
            return int(value)
    return None


def read(ctx):
    tr = ctx["trace"]
    found = [points(n) for n, _, _ in tr.host if n.startswith(SPAN)]
    if not tr.dev or not found or None in found:
        return None
    return tr.busy_s * 1e6 / (sum(found) / 1000.0)
