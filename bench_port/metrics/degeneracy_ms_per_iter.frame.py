"""Device ms per ICP iteration of the ``degeneracy`` module of the map
loop's step replays: the Schur-complement analysis,
``ops.degeneracy.analyze``. From ``tracing.module_times`` over a
profiled window of the program's own (``program_window``). Moves
``frame_ms``."""
import program_window


def read(ctx):
    return program_window.step_module_ms(ctx, "degeneracy")
