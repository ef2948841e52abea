from .mesh import (active, average_gradients, barrier, broadcast_modules,
                   check_flags, check_spatial, gather_rows, global_shape,
                   grid, init_distributed, is_main, launch, mean_all_reduce,
                   mean_values, rank, rows, sharded, shutdown, unsharded,
                   workers, world)
from . import spatial

__all__ = ["active", "average_gradients", "barrier", "broadcast_modules",
           "check_flags", "check_spatial", "gather_rows", "global_shape",
           "grid", "init_distributed", "is_main", "launch", "mean_all_reduce",
           "mean_values", "rank", "rows", "sharded", "shutdown", "spatial",
           "unsharded", "workers", "world"]
