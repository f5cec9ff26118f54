"""Step replays per batch: the most iterations of any lane (the port's
``BatchICPResult.iterations``), which the loop's steps run to: moves
``reg_per_s``."""


def read(ctx):
    return ctx["counts"].get("steps_per_batch")
