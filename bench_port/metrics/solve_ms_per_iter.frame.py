"""Device ms per ICP iteration of the ``solve`` module of the map loop's
step replays: the PCG solve and the abort mask, ``ops.solvers``. From
``tracing.module_times`` over a profiled window of the program's own
(``program_window``). Moves ``frame_ms``."""
import program_window


def read(ctx):
    return program_window.step_module_ms(ctx, "solve")
