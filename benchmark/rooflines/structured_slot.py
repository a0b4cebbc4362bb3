"""Operations and bytes of one float64 apply of the structured box's
stiffness operator, y = K u, counted as the work needs them whatever
implements it.

Operations: every hexahedral cell of the lattice couples its 27 nodes (3 x 3
x 3 on the half-spaced lattice), 81 DOFs, through one 81 x 81 cell matrix
(the sum of its 6 tetrahedra's); a cell's product is 2 * 81^2 operations.

Bytes: u read once and y written once (8 bytes per DOF each), and the one
cell matrix the lattice shares (81^2 * 8); the supports are a handful of
DOFs and count nothing.
"""

import numpy as np

from reference import box_cells


def count(config: dict):
    cells = box_cells(config)
    ndof = 3 * int(np.prod([2 * c + 1 for c in cells]))
    flops = 2.0 * 81 ** 2 * float(np.prod(cells))
    nbytes = 8.0 * 2 * ndof + 8.0 * 81 ** 2
    return flops, nbytes
