"""Device ms per frame of the map loop's prologue replays: the
constant-velocity seed, the cull and the pair list that the frame reuses
(``models.odometry``, ``MapLoop.prologue``).  From
``tracing.module_times`` (``program_window``).  Moves ``frame_ms``."""
import program_window


def read(ctx):
    return program_window.part_ms(ctx, program_window.PROLOGUE)
