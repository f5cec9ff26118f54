"""Share of the fleet's lane-steps that did work: 100 x the lanes' ICP
iterations / (sensors x step replays), over the window's ticks.  A lane
that has converged rides the remaining steps under the lane mask
(``models.icp_batch``, BatchLoop), doing no search.  Moves
``frame_ms``."""


def read(ctx):
    return ctx["counts"].get("lane_occupancy")
