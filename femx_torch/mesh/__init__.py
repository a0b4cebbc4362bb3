"""Mesh data model, generators and .msh I/O (host numpy)."""

from femx_torch.mesh.core import Mesh, nearest_node, nodes_in_physical_group, relabel_nodes
from femx_torch.mesh.generators import (
    FrameBuilder, StructuredBoxInfo, box_tet10, box_tet10_from_cells, cantilever_line_mesh,
    tet4_to_tet10)
from femx_torch.mesh.msh_io import read_msh, write_msh

__all__ = ["Mesh", "nearest_node", "nodes_in_physical_group", "relabel_nodes",
           "FrameBuilder", "StructuredBoxInfo", "box_tet10", "box_tet10_from_cells",
           "cantilever_line_mesh", "tet4_to_tet10", "read_msh", "write_msh"]
