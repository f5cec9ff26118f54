"""Command-line tools of the port, one module per script of the
repository's ``scripts/`` folder it stands in for (same file name): the
trajectory-evaluation CLIs and the degenerate-corridor experiment.  Each
runs with ``python -m dcreg_tpu_torch.scripts.<name>``."""
