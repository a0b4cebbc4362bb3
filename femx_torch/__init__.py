"""femx_torch — the PyTorch/CUDA port of femx for one NVIDIA H100.

The solid reaction solve runs on the card for a structured box Tet10 mesh
(matrix-free lattice operator, its gather + cell matmul a hand-written CUDA
kernel) and for any Tet10 mesh given as a Mesh or read from a Gmsh .msh
file (dense Cholesky, or the transpose-gather, group-ELL or cluster
operator, their row gathers a hand-written CUDA kernel, with block-Jacobi
or lattice-multigrid PCG), with the analysis' modal analysis
(femx_torch.modal), nodal stresses, load cases and checkpoint/resume
(femx_torch.checkpoint); `python -m femx_torch.bench` runs femx's bench.py
flow. The beam frame (BeamAnalysis, its section warping FEM on the card),
shaft modal (ShaftModalAnalysis), 2D plane (PlaneAnalysis) and
axisymmetric pipe (PipeThermalAnalysis) products run there too, the 2D
matrix-free solves' element gathers through the same take_rows kernel.
Entry points run on CUDA unless the caller passes ``device="cpu"``;
without CUDA they raise. The package imports torch and numpy, never jax
and nothing of femx.
"""

from femx_torch import config as config  # noqa: F401  (TF32 off at import)

from femx_torch.analysis import (BeamAnalysis, ForceAnalysis, PipeThermalAnalysis,
                                 PlaneAnalysis, ShaftModalAnalysis, SolidReactionAnalysis)
from femx_torch.config import ReferenceCompat, default_dtype, set_default_dtype
from femx_torch.mesh import (FrameBuilder, Mesh, box_tet10, box_tet10_from_cells,
                             cantilever_line_mesh, nodes_in_physical_group, read_msh, write_msh)
from femx_torch.sections import (SectionProperties, calculate_section_properties,
                                 compute_properties)

__version__ = "0.1.0"

__all__ = [
    "ReferenceCompat",
    "default_dtype",
    "set_default_dtype",
    "Mesh",
    "FrameBuilder",
    "read_msh",
    "write_msh",
    "box_tet10",
    "box_tet10_from_cells",
    "cantilever_line_mesh",
    "nodes_in_physical_group",
    "calculate_section_properties",
    "compute_properties",
    "SectionProperties",
    "BeamAnalysis",
    "SolidReactionAnalysis",
    "ForceAnalysis",
    "PlaneAnalysis",
    "PipeThermalAnalysis",
    "ShaftModalAnalysis",
]
