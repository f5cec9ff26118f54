"""Step replays per tick of the fleet's map loop: the slowest lane's ICP
iterations (the port's ``MapOdometryResult.iterations`` of the tick's
sensors), which every lane's tick waits for (``models.odometry``,
``run_odometry_fleet``).  Moves ``frame_ms``."""


def read(ctx):
    return ctx["counts"].get("steps_per_tick")
