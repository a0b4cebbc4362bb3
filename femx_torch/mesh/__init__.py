"""Mesh data model, structured box generator and .msh I/O (host numpy)."""

from femx_torch.mesh.core import Mesh, nearest_node, nodes_in_physical_group, relabel_nodes
from femx_torch.mesh.generators import (
    StructuredBoxInfo, box_tet10, box_tet10_from_cells, tet4_to_tet10)
from femx_torch.mesh.msh_io import read_msh, write_msh

__all__ = ["Mesh", "nearest_node", "nodes_in_physical_group", "relabel_nodes",
           "StructuredBoxInfo", "box_tet10", "box_tet10_from_cells", "tet4_to_tet10",
           "read_msh", "write_msh"]
