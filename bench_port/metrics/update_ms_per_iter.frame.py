"""Device ms per ICP iteration of the ``update`` module of the map loop's
step replays: the step's bookkeeping in ``models.icp_batch`` (history,
``boxplus``, the convergence test, the state). From
``tracing.module_times`` over a profiled window of the program's own
(``program_window``). Moves ``frame_ms``."""
import program_window


def read(ctx):
    return program_window.step_module_ms(ctx, "update")
