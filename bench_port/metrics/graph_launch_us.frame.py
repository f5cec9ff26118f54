"""Host microseconds per frame inside ``graphs.replay`` spans (the
``cudaGraphLaunch`` of each replay and its counters), with the profiler
off, over the recorded pass of ``program_window``.  Moves
``frame_ms``."""
import program_window


def read(ctx):
    rec = program_window.recorded(ctx)
    return 1e6 * rec["replay_host_s"] / rec["frames"] if rec else None
