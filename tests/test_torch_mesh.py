"""femx_torch mesh host layer == femx's on the same inputs."""

import numpy as np
import pytest
import torch

import femx.mesh as fx_mesh
from femx.mesh.generators import tet4_to_tet10 as fx_tet4_to_tet10
import femx_torch.mesh as pt_mesh
from femx_torch.mesh.generators import tet4_to_tet10 as pt_tet4_to_tet10

torch.set_num_threads(2)

CORNERS = [(0, 0, 0), (0, 0, 0.8), (0.8, 0, 0), (0.8, 0, 0.8)]


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.points, b.points)
    assert set(a.cells) == set(b.cells)
    for k in a.cells:
        np.testing.assert_array_equal(a.cells[k], b.cells[k])
        np.testing.assert_array_equal(a.cell_physical[k], b.cell_physical[k])
    assert a.field_data == b.field_data
    assert getattr(a, "bc_embed_info", None) == getattr(b, "bc_embed_info", None)
    if a.structured is None:
        assert b.structured is None
    else:
        for attr in ("n_cells", "spacing", "origin", "grid_shape", "num_nodes"):
            assert getattr(a.structured, attr) == getattr(b.structured, attr), attr


@pytest.mark.parametrize("args,kw", [
    # the reference default case (README quick start)
    ((0.8, 0.2, 0.8, 0.05), dict(force_points=[(0.4, 0.2, 0.4)], fix_points=CORNERS)),
    # off-lattice points: embedded (mesh loses its lattice) or snapped
    ((0.5, 0.3, 0.4, 0.1), dict(force_points=[(0.23, 0.3, 0.17)],
                                fix_points=[(0.0, 0.013, 0.0)])),
    ((0.5, 0.3, 0.4, 0.1), dict(force_points=[(0.23, 0.3, 0.17)],
                                fix_points=[(0.0, 0.013, 0.0)], embed_points=False)),
    ((1.6, 0.3, 0.4, 0.1), dict(origin=(1.0, -2.0, 0.5))),
])
def test_box_tet10_matches(args, kw):
    _same_mesh(fx_mesh.box_tet10(*args, **kw), pt_mesh.box_tet10(*args, **kw))


def test_box_tet10_from_cells_matches():
    kw = dict(force_points=[(0.5, 0.09, 0.045)], fix_points=[(0, 0, 0)])
    a = fx_mesh.box_tet10_from_cells((11, 3, 3), (1.0 / 11, 0.03, 0.03), **kw)
    b = pt_mesh.box_tet10_from_cells((11, 3, 3), (1.0 / 11, 0.03, 0.03), **kw)
    _same_mesh(a, b)


def test_groups_and_nearest_node_match():
    kw = dict(force_points=[(0.4, 0.2, 0.4)], fix_points=CORNERS)
    a = fx_mesh.box_tet10(0.8, 0.2, 0.8, 0.1, **kw)
    b = pt_mesh.box_tet10(0.8, 0.2, 0.8, 0.1, **kw)
    for group in ("Diri_BCs", "Neumann_BCs", "box", "missing"):
        np.testing.assert_array_equal(fx_mesh.nodes_in_physical_group(a, group),
                                      pt_mesh.nodes_in_physical_group(b, group))
    cand = pt_mesh.nodes_in_physical_group(b, "Diri_BCs", "vertex")
    for pos in [(0.1, 0.0, 0.7), (0.79, 0.2, 0.01)]:
        assert (fx_mesh.nearest_node(a.points, pos, cand)
                == pt_mesh.nearest_node(b.points, pos, cand))
        assert fx_mesh.nearest_node(a.points, pos) == pt_mesh.nearest_node(b.points, pos)


def test_tet4_to_tet10_matches():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(6, 3))
    conn4 = np.array([[0, 1, 2, 3], [1, 2, 3, 4], [2, 3, 4, 5]])
    pa, ca = fx_tet4_to_tet10(pts, conn4)
    pb, cb = pt_tet4_to_tet10(pts, conn4)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ca, cb)
