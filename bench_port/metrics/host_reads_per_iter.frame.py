"""Host reads of the done flag per ICP iteration (``graphs.STATS.host_reads``,
counted in ``graphs.drive``) over the recorded pass of
``program_window``.  A frame reads before every step but its first and
once more to find itself done; a frame at the iteration cap reads once
less.  Moves ``frame_ms``."""
import program_window


def read(ctx):
    rec = program_window.recorded(ctx)
    if not rec or not rec["iterations"]:
        return None
    return rec["host_reads"] / rec["iterations"]
