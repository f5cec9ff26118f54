"""Device ms per ICP iteration of the ``search`` module of the map loop's
step replays: the live-mask cull over the reused pair list, K1
(``batched_block_knn``) and the 5th-neighbour rows: ``ops.block_knn``.
From ``tracing.module_times`` over a profiled window of the program's
own (``program_window``). Moves ``frame_ms``."""
import program_window


def read(ctx):
    return program_window.step_module_ms(ctx, "search")
