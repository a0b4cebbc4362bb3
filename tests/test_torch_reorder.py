"""femx_torch.mesh.reorder == femx.mesh.reorder exactly on a relabelled box
and on random points: Morton codes (several bit depths), the element Morton
order, first-touch relabelling (also with unreferenced nodes), the full
locality reordering and the element node spans."""

import numpy as np
import pytest

from femx.mesh import box_tet10
from femx.mesh import reorder as fx
from femx_torch.mesh import reorder as pt


@pytest.fixture(scope="module")
def scrambled():
    mesh = box_tet10(0.3, 0.2, 0.4, mesh_size=0.1)
    conn = np.asarray(mesh.cells["tetra10"])
    pts = np.asarray(mesh.points)
    relabel = np.random.default_rng(0).permutation(len(pts))
    pts_s = np.empty_like(pts)
    pts_s[relabel] = pts
    return pts_s, relabel[conn]


@pytest.mark.parametrize("bits", [4, 10, 21])
def test_morton_codes_equal(scrambled, bits):
    pts, _ = scrambled
    rnd = np.random.default_rng(1).standard_normal((500, 3))
    for p in (pts, rnd, np.zeros((3, 3))):  # the last: zero span on every axis
        got, want = pt.morton_codes(p, bits), fx.morton_codes(p, bits)
        assert got.dtype == want.dtype == np.uint64
        np.testing.assert_array_equal(got, want)


def test_orders_and_relabel_equal(scrambled):
    pts, conn = scrambled
    np.testing.assert_array_equal(pt.element_morton_order(pts, conn),
                                  fx.element_morton_order(pts, conn))
    eorder = fx.element_morton_order(pts, conn)
    for order in (None, eorder):
        np.testing.assert_array_equal(pt.first_touch_relabel(conn, len(pts), order),
                                      fx.first_touch_relabel(conn, len(pts), order))
    # nodes that no element references keep a stable tail numbering
    np.testing.assert_array_equal(pt.first_touch_relabel(conn[:5], len(pts), None),
                                  fx.first_touch_relabel(conn[:5], len(pts), None))


def test_reorder_for_locality_and_spans_equal(scrambled):
    pts, conn = scrambled
    for a, b in zip(pt.reorder_for_locality(pts, conn), fx.reorder_for_locality(pts, conn)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pt.element_node_spans(conn), fx.element_node_spans(conn))
