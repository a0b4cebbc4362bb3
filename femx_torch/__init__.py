"""femx_torch — the PyTorch/CUDA port of femx for one NVIDIA H100.

The solid reaction solve runs on the card for a structured box Tet10 mesh
(matrix-free lattice operator, its gather + cell matmul a hand-written CUDA
kernel) and for any Tet10 mesh given as a Mesh or read from a Gmsh .msh
file (dense Cholesky, or the transpose-gather, group-ELL or cluster
operator, their row gathers a hand-written CUDA kernel, with block-Jacobi
or lattice-multigrid PCG), with the analysis' modal analysis
(femx_torch.modal), nodal stresses, load cases and checkpoint/resume
(femx_torch.checkpoint); `python -m femx_torch.bench` runs femx's bench.py
flow. Entry points run on CUDA unless the caller passes ``device="cpu"``;
without CUDA they raise. The package imports torch and numpy, never jax
and nothing of femx.
"""

from femx_torch import config as config  # noqa: F401  (TF32 off at import)

from femx_torch.analysis.solid import ForceAnalysis, SolidReactionAnalysis
from femx_torch.config import ReferenceCompat, default_dtype, set_default_dtype
from femx_torch.mesh import (Mesh, box_tet10, box_tet10_from_cells, nodes_in_physical_group,
                             read_msh, write_msh)

__version__ = "0.1.0"

__all__ = [
    "ReferenceCompat",
    "default_dtype",
    "set_default_dtype",
    "Mesh",
    "box_tet10",
    "box_tet10_from_cells",
    "nodes_in_physical_group",
    "read_msh",
    "write_msh",
    "SolidReactionAnalysis",
    "ForceAnalysis",
]
