"""femx_torch.parallel — multi-rank solves over torch.distributed (port of
femx/parallel): element, DOF and batch parallelism, the z-slab halo
structured solve with its distributed multigrid, the sharded unstructured
operator with its distributed lattice MG, distributed modal analysis, and
`launch`, which starts the ranks (one process each).

femx drives N devices from one process; here each rank is a process that
builds the same analysis, so SolidReactionAnalysis(devices=N) runs inside
an N-rank group started by `launch` (or ``python -m femx_torch solid
--devices N``).
"""

from femx_torch.parallel.comm import RankResult, backend_for, launch
from femx_torch.parallel.halo import DistributedMultigrid, HaloStructuredOperator, pcg_halo
from femx_torch.parallel.modal import modal_shift_invert_halo
from femx_torch.parallel.ops import (RankMesh, ShardedSolidOperator, batched_solve_cg,
                                     device_mesh, pad_elements)
from femx_torch.parallel.structured import ShardedStructuredOperator
from femx_torch.parallel.tg_lattice import DistributedUnstructuredSolver
from femx_torch.parallel.tg_sharded import ShardedTGOperator, pcg_tg_sharded

__all__ = [
    "DistributedMultigrid",
    "DistributedUnstructuredSolver",
    "HaloStructuredOperator",
    "ShardedTGOperator",
    "pcg_halo",
    "pcg_tg_sharded",
    "modal_shift_invert_halo",
    "ShardedSolidOperator",
    "ShardedStructuredOperator",
    "batched_solve_cg",
    "device_mesh",
    "pad_elements",
    "RankMesh",
    "RankResult",
    "backend_for",
    "launch",
]
