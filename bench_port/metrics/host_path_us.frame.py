"""Host microseconds per frame in ``run_odometry_map`` outside its
replays and its reads of the done flag: the ``odometry.call`` spans' time
less their ``graphs.replay`` and ``graphs.done_read`` spans (the
arguments, the binding and state loads, the result copies), with the
profiler off, over the recorded pass of ``program_window``.  Moves
``frame_ms``."""
import program_window


def read(ctx):
    rec = program_window.recorded(ctx)
    return 1e6 * rec["host_path_s"] / rec["frames"] if rec else None
