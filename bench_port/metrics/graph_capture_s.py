"""Seconds the port spent warming up and capturing its CUDA graphs in
set-up (``dcreg_tpu_torch.graphs.CACHE.capture_seconds``): moves
``setup_s``."""


def read(ctx):
    if ctx["device"] == "cpu":
        return None
    return ctx["capture_seconds"]
