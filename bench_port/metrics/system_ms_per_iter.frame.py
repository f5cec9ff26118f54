"""Device ms per ICP iteration of the ``tail.system`` module of the map
loop's step replays: the residuals, robust weights, GN rows and the
reductions to H and g of ``ops.soa_tail``. From ``tracing.module_times``
over a profiled window of the program's own (``program_window``). Moves
``frame_ms``."""
import program_window


def read(ctx):
    return program_window.step_module_ms(ctx, "tail.system")
