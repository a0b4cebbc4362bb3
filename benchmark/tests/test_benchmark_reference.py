"""The plain reference against the port on the CPU, at small boxes."""

import numpy as np
import pytest
import torch

import reference
from harness.cells import program_loads

import femx_torch
from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.mesh import box_tet10, relabel_nodes

DIMS = (0.8, 0.2, 0.8)
SUPPORTS = [{"x": x, "y": 0.0, "z": z} for x in (0.0, 0.8) for z in (0.0, 0.8)]
# lattice nodes of the box at a mesh size of 0.2 m (4 x 1 x 4 cells)
POINTS = [{"x": 0.4, "y": 0.2, "z": 0.4}, {"x": 0.8, "y": 0.2, "z": 0.8},
          {"x": 0.2, "y": 0.1, "z": 0.6}]


def _config(mesh_size):
    return {"box": {"dims_m": list(DIMS)}, "mesh_size_m": mesh_size,
            "material": {"E_pa": 2e11, "nu": 0.3}, "supports": SUPPORTS}


def _mesh(mesh_size, points):
    return box_tet10(*DIMS, mesh_size, force_points=points,
                     fix_points=[(s["x"], s["y"], s["z"]) for s in SUPPORTS])


@pytest.mark.parametrize("mesh_size", [0.2, 0.3])  # 4 x 1 x 4 cubic cells; 3 x 1 x 3, not cubic
def test_stiffness_equals_the_ports(mesh_size):
    model = reference.BoxModel(_config(mesh_size), block=7)
    mesh = _mesh(mesh_size, None)
    order = model.order_of(mesh.points)
    op = StructuredSolidOperator.from_mesh(mesh, 2e11, 0.3, weight=1.0 / 24.0,
                                           dtype=np.float64, device="cpu")
    u = np.random.default_rng(1).standard_normal(3 * mesh.num_nodes)
    y = op.to_global(op.apply(torch.as_tensor(op.to_internal(u))).numpy())
    want = model.apply(model.to_reference(u, order))
    assert np.abs(model.to_reference(y, order) - want).max() <= 1e-13 * np.abs(want).max()
    # rigid translations are in K's null space
    t = np.tile([1.0, -2.0, 0.5], model.lattice.num_nodes)
    assert np.abs(model.apply(t)).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("relabel", [False, True])
def test_the_ports_answer_passes_and_a_wrong_one_fails(relabel):
    model = reference.BoxModel(_config(0.2))
    loads = [dict(p, fx=300.0, fy=-2500.0, fz=40.0) for p in POINTS[:2]]
    mesh = _mesh(0.2, [(p["x"], p["y"], p["z"]) for p in POINTS])
    if relabel:
        mesh = relabel_nodes(mesh, np.random.default_rng(5).permutation(mesh.num_nodes))
    fix = [{"pos_x": s["x"], "pos_y": s["y"], "pos_z": s["z"], "fix_x": 0, "fix_y": 0,
            "fix_z": 0} for s in SUPPORTS]
    fa = femx_torch.SolidReactionAnalysis(mesh, program_loads(loads), fix, E=2e11, v=0.3,
                                          verbose=False, device="cpu")
    fa.run_simulation()
    order = model.order_of(fa.points)
    u = model.to_reference(fa.u, order)
    r = model.to_reference(fa.reaction_forces, order)
    got = model.judge(loads, u, r)
    assert got["residual"] <= 1e-10 and got["support"] == 0.0 and got["reaction"] <= 1e-12
    other = [dict(loads[0], x=POINTS[2]["x"], y=POINTS[2]["y"], z=POINTS[2]["z"])] + loads[1:]
    assert model.judge(other, u, r)["residual"] >= 0.1
    assert model.judge(loads, 1.001 * u, r)["residual"] >= 1e-4
    assert model.judge(loads, u, 1.01 * r)["reaction"] >= 1e-3


def test_points_off_the_lattice_are_refused():
    model = reference.BoxModel(_config(0.2))
    assert reference.box_cells(_config(0.0125)) == (64, 16, 64)
    with pytest.raises(ValueError):
        model.loads([{"x": 0.05, "y": 0.2, "z": 0.4, "fx": 1.0, "fy": 0.0, "fz": 0.0}])
    pts = model.points.copy()
    pts[3] += 1e-4
    with pytest.raises(ValueError):
        model.order_of(pts)
