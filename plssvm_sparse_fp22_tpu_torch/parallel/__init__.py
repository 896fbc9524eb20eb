"""Multi-device training and prediction: the mesh (``mesh.py``) and the
row-sharded dense learn, predict and ``w`` (``sharded.py``)."""

from .mesh import DATA_AXIS, make_mesh
from .sharded import (make_sharded_learn, make_sharded_learn_fns, make_sharded_predict,
                      make_sharded_w, shard_rows, shard_system)

__all__ = ["DATA_AXIS", "make_mesh", "make_sharded_learn", "make_sharded_learn_fns",
           "make_sharded_predict", "make_sharded_w", "shard_rows", "shard_system"]
