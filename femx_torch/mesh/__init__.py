"""Mesh data model and structured box generator (host numpy)."""

from femx_torch.mesh.core import Mesh, nearest_node, nodes_in_physical_group
from femx_torch.mesh.generators import (
    StructuredBoxInfo, box_tet10, box_tet10_from_cells, tet4_to_tet10)

__all__ = ["Mesh", "nearest_node", "nodes_in_physical_group", "StructuredBoxInfo",
           "box_tet10", "box_tet10_from_cells", "tet4_to_tet10"]
