"""dcreg_tpu_torch -- the PyTorch/CUDA port of ``dcreg_tpu``.

Layout mirrors ``dcreg_tpu/`` module for module; each module's docstring
names the JAX module it is held against.  The package imports ``torch``,
``numpy``, ``yaml`` and the standard library only.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
