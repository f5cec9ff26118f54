"""Device ms per frame of the map loop's epilogue replays: the reuse
guard, the frame's analysis of its last H and its output row
(``models.odometry``, ``MapLoop.epilogue``).  From
``tracing.module_times`` (``program_window``).  Moves ``frame_ms``."""
import program_window


def read(ctx):
    return program_window.part_ms(ctx, program_window.EPILOGUE)
