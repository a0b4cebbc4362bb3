"""Operations and bytes of one float64 apply of a Tet10 mesh's stiffness
operator given by its nodes and elements, y = K u, counted as the work
needs them whatever implements it (the transpose-gather operator of the
mesh-file route precomputes more than this and reads it back).

Operations: each tetrahedron's 30 x 30 element matrix times its 30 DOFs,
2 * 30^2 operations per element.

Bytes: u read once and y written once (8 bytes per DOF each), the node
coordinates (3 float64 per node) and the connectivity (10 int32 per
element), from which the element matrices follow.
"""

import numpy as np

from reference import box_cells


def count(config: dict):
    cells = box_cells(config)
    nodes = int(np.prod([2 * c + 1 for c in cells]))
    tets = 6 * int(np.prod(cells))
    flops = 2.0 * 30 ** 2 * tets
    nbytes = 8.0 * 2 * 3 * nodes + 8.0 * 3 * nodes + 4.0 * 10 * tets
    return flops, nbytes
