"""Multi-device training and prediction: the mesh (``mesh.py``) and the
sharded learns, predict and ``w`` (``sharded.py``): rows or features of
dense data, rows of sparse data."""

from .mesh import DATA_AXIS, make_mesh
from .sharded import (make_feature_sharded_learn, make_feature_sharded_learn_fns,
                      make_sharded_learn, make_sharded_learn_fns, make_sharded_predict,
                      make_sharded_sparse_linear_learn, make_sharded_sparse_panel_learn,
                      make_sharded_sparse_streaming_learn, make_sharded_w, shard_rows,
                      shard_sparse_system, shard_sparse_tiled_system, shard_system,
                      shard_system_feature)

__all__ = ["DATA_AXIS", "make_mesh", "make_feature_sharded_learn",
           "make_feature_sharded_learn_fns", "make_sharded_learn", "make_sharded_learn_fns",
           "make_sharded_predict", "make_sharded_sparse_linear_learn",
           "make_sharded_sparse_panel_learn", "make_sharded_sparse_streaming_learn",
           "make_sharded_w", "shard_rows", "shard_sparse_system", "shard_sparse_tiled_system",
           "shard_system", "shard_system_feature"]
