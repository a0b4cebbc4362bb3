"""femx_torch — the PyTorch/CUDA port of femx for one NVIDIA H100.

The structured solid reaction solve (box Tet10 mesh, matrix-free lattice
operator, block-Jacobi or multigrid PCG with float64 refinement, reactions)
runs on the card, its gather + cell matmul in a hand-written CUDA kernel.
Entry points run on CUDA unless the caller passes ``device="cpu"``; without
CUDA they raise. The package imports torch and numpy, never jax and nothing
of femx.
"""

from femx_torch import config as config  # noqa: F401  (TF32 off at import)

from femx_torch.analysis.solid import ForceAnalysis, SolidReactionAnalysis
from femx_torch.config import ReferenceCompat, default_dtype
from femx_torch.mesh import Mesh, box_tet10, box_tet10_from_cells, nodes_in_physical_group

__version__ = "0.1.0"

__all__ = [
    "ReferenceCompat",
    "default_dtype",
    "Mesh",
    "box_tet10",
    "box_tet10_from_cells",
    "nodes_in_physical_group",
    "SolidReactionAnalysis",
    "ForceAnalysis",
]
