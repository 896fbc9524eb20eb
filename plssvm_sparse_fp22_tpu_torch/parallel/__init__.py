"""Multi-device training and prediction: the mesh (``mesh.py``), the
sharded learns, predict and ``w`` (``sharded.py``): rows or features of
dense data, rows of sparse data; and several processes on one problem
(``distributed.py``)."""

from .distributed import initialize_distributed, make_global_row_sharded
from .mesh import DATA_AXIS, GlobalMesh, make_local_mesh, make_mesh
from .sharded import (make_feature_sharded_learn, make_feature_sharded_learn_fns,
                      make_sharded_learn, make_sharded_learn_fns, make_sharded_predict,
                      make_sharded_sparse_linear_learn, make_sharded_sparse_panel_learn,
                      make_sharded_sparse_streaming_learn, make_sharded_w, shard_rows,
                      shard_sparse_system, shard_sparse_tiled_system, shard_system,
                      shard_system_feature)

__all__ = ["DATA_AXIS", "GlobalMesh", "initialize_distributed", "make_global_row_sharded",
           "make_local_mesh", "make_mesh", "make_feature_sharded_learn",
           "make_feature_sharded_learn_fns", "make_sharded_learn", "make_sharded_learn_fns",
           "make_sharded_predict", "make_sharded_sparse_linear_learn",
           "make_sharded_sparse_panel_learn", "make_sharded_sparse_streaming_learn",
           "make_sharded_w", "shard_rows", "shard_sparse_system", "shard_sparse_tiled_system",
           "shard_system", "shard_system_feature"]
