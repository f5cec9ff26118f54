"""Device ms per ICP iteration of the ``tail.planes`` module of the map
loop's step replays: the neighbour gather, covariances, the closed-form
3x3 eigensolve and the plane fit of ``ops.soa_tail``. From
``tracing.module_times`` over a profiled window of the program's own
(``program_window``). Moves ``frame_ms``."""
import program_window


def read(ctx):
    return program_window.step_module_ms(ctx, "tail.planes")
