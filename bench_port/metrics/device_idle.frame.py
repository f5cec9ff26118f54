"""Share of the traced window in which no operation ran on the device
(100 x (1 - busy / window)), from the profiler's trace."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.dev:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
