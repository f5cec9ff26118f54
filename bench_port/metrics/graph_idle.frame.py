"""Share of the recorded pass's wall in which the device ran no graph
replay, with the profiler off: 100 x (1 - the sum of each replay's
interval between its two CUDA events / the wall of ``tracing.record()``),
over the recorded pass of ``program_window``.  Eager copies and kernels
outside the replays (the scan's load into the state, the result copies,
the pose read-back) count as idle.  A replay's interval starts when the
stream reaches its start event, recorded before ``cudaGraphLaunch``: where
the stream was empty, the device's wait for the launch counts as busy.
So this is a lower bound on the idle share; ``program_window`` prints the
upper bound beside it, each interval less its replay's host time.  Moves
``frame_ms``."""
import program_window


def read(ctx):
    rec = program_window.recorded(ctx)
    if not rec or rec["untimed"] or not rec["wall_s"]:
        return None
    return 100.0 * (1.0 - rec["replay_device_s"] / rec["wall_s"])
