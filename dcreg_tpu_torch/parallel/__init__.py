"""Multi-device scale-out: mesh construction and sharded registration
(counterpart of ``dcreg_tpu/parallel/__init__.py``).

See ``sharded.py`` for the design (data axis = source points, map axis =
target map shards; the 6x6 GN system all-reduced over data).
"""
from .sharded import (ShardedICPResult, factor_mesh, make_mesh,
                      pad_for_mesh, shard_points, sharded_icp_register)

__all__ = ["ShardedICPResult", "factor_mesh", "make_mesh", "pad_for_mesh",
           "shard_points", "sharded_icp_register"]
