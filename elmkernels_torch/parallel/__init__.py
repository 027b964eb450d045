"""Column sharding over ``torch.distributed`` ranks.

Counterpart of ``elmkernels_tpu/parallel``.  The reference's only parallel
axis is the column batch (an MPI rank per lat/lon block, no physics
communication between ranks).  Here each rank of a process group runs its
own contiguous block of columns on its own device, and only the domain
diagnostics cross ranks, by ``all_reduce`` (:mod:`.reductions`).
"""

from elmkernels_torch.parallel.mesh import (ColumnMesh, column_mesh,
                                            shard_forcing, shard_params,
                                            shard_state)
from elmkernels_torch.parallel.reductions import (MinMaxSum, min_max_mean,
                                                  min_max_sum)

__all__ = ["ColumnMesh", "column_mesh", "shard_state", "shard_params",
           "shard_forcing", "MinMaxSum", "min_max_sum", "min_max_mean"]
