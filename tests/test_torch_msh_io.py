"""femx_torch .msh I/O == femx's: round trips through 2.2 ASCII, 2.2 binary
and a 4.1 text give identical points, cells, physical tags and field_data,
read by either package; plus the Mesh properties and node relabelling."""

import io

import numpy as np
import pytest

import femx
from femx.mesh import msh_io as fx_io
from femx.mesh.core import NAME_TO_GMSH_TYPE as FX_NAME_TO_GMSH_TYPE
from femx_torch.mesh import box_tet10, msh_io as pt_io, relabel_nodes
from femx_torch.mesh.core import NAME_TO_GMSH_TYPE, Mesh


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a.points), np.asarray(b.points))
    assert set(a.cells) == set(b.cells)
    for k in a.cells:
        np.testing.assert_array_equal(np.asarray(a.cells[k]), np.asarray(b.cells[k]))
        assert np.asarray(a.cells[k]).dtype == np.asarray(b.cells[k]).dtype
        np.testing.assert_array_equal(np.asarray(a.cell_physical[k]),
                                      np.asarray(b.cell_physical[k]))
    assert dict(a.field_data) == dict(b.field_data)


@pytest.fixture(scope="module")
def mesh():
    """A small relabelled box with both BC point groups."""
    m = box_tet10(0.3, 0.2, 0.2, 0.1, force_points=[(0.3, 0.1, 0.1)],
                  fix_points=[(0, 0, 0), (0, 0.2, 0.2)])
    return relabel_nodes(m, np.random.default_rng(0).permutation(m.num_nodes))


@pytest.mark.parametrize("binary", [False, True])
def test_msh22_round_trip_matches_femx(tmp_path, mesh, binary):
    p_pt, p_fx = tmp_path / "pt.msh", tmp_path / "fx.msh"
    pt_io.write_msh(str(p_pt), mesh, binary=binary)
    fx_io.write_msh(str(p_fx), femx.Mesh(points=mesh.points, cells=mesh.cells,
                                          cell_physical=mesh.cell_physical,
                                          field_data=mesh.field_data), binary=binary)
    assert p_pt.read_bytes() == p_fx.read_bytes()  # the same file, byte for byte
    got = pt_io.read_msh(str(p_pt))
    _assert_same(got, fx_io.read_msh(str(p_pt)))
    if binary:
        _assert_same(got, mesh)
    else:  # the ASCII writer prints 16 significant digits, as femx's does
        np.testing.assert_allclose(got.points, mesh.points, rtol=1e-15, atol=1e-16)
        _assert_same(Mesh(points=mesh.points, cells=got.cells, cell_physical=got.cell_physical,
                          field_data=got.field_data), mesh)
    # the other inputs read_msh takes: bytes, an open file, the text itself
    _assert_same(pt_io.read_msh(p_pt.read_bytes()), got)
    with open(p_pt, "rb") as f:
        _assert_same(pt_io.read_msh(f), got)
    if not binary:
        _assert_same(pt_io.read_msh(p_pt.read_text()), got)


def _msh41_text(mesh: Mesh) -> str:
    """A gmsh 4.1 ASCII file of `mesh`: sparse node tags, one point entity
    per vertex physical group, one volume entity for the tets."""
    tags = 3 * np.arange(mesh.num_nodes) + 7  # sparse, ascending
    out = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$PhysicalNames",
           str(len(mesh.field_data))]
    out += [f'{dim} {tag} "{name}"' for name, (tag, dim) in mesh.field_data.items()]
    out += ["$EndPhysicalNames", "$Entities"]
    vtags = sorted(set(mesh.cell_physical["vertex"].tolist()))
    out.append(f"{len(vtags)} 0 0 1")
    out += [f"{i + 1} 0 0 0 1 {t}" for i, t in enumerate(vtags)]
    out += ["1 0 0 0 1 1 1 1 1 0", "$EndEntities", "$Nodes",
            f"1 {mesh.num_nodes} {tags.min()} {tags.max()}", f"3 1 0 {mesh.num_nodes}"]
    out += [str(t) for t in tags]
    out += [f"{x!r} {y!r} {z!r}" for x, y, z in mesh.points.tolist()]
    out.append("$EndNodes")
    blocks = [(0, i + 1, 15, mesh.cells["vertex"][mesh.cell_physical["vertex"] == t])
              for i, t in enumerate(vtags)] + [(3, 1, 11, mesh.cells["tetra10"])]
    n_el = sum(len(b[3]) for b in blocks)
    out += ["$Elements", f"{len(blocks)} {n_el} 1 {n_el}"]
    eid = 1
    for dim, etag, etype, conn in blocks:
        out.append(f"{dim} {etag} {etype} {len(conn)}")
        for row in conn:
            out.append(" ".join([str(eid)] + [str(tags[n]) for n in row]))
            eid += 1
    out.append("$EndElements")
    return "\n".join(out) + "\n"


def test_msh41_text_matches_femx(mesh):
    text = _msh41_text(mesh)
    got = pt_io.read_msh(text)
    _assert_same(got, fx_io.read_msh(text))
    np.testing.assert_array_equal(got.points, mesh.points)
    for k in mesh.cells:
        np.testing.assert_array_equal(got.cells[k], mesh.cells[k])
        np.testing.assert_array_equal(got.cell_physical[k], mesh.cell_physical[k])


def test_reader_rejects_what_femx_rejects():
    with pytest.raises(ValueError, match="MeshFormat"):
        pt_io.read_msh(b"not a mesh")
    bad = "$MeshFormat\n1.0 0 8\n$EndMeshFormat\n"
    with pytest.raises(ValueError, match="version"):
        pt_io.read_msh(bad)
    with pytest.raises(ValueError, match="2.2"):
        pt_io.write_msh(io.StringIO(), Mesh(points=np.zeros((1, 3))), fmt="4.1")


def test_mesh_properties_and_relabel(mesh):
    assert NAME_TO_GMSH_TYPE == FX_NAME_TO_GMSH_TYPE
    assert mesh.cells_dict is mesh.cells
    assert mesh.cell_data_dict == {"gmsh:physical": mesh.cell_physical}
    assert mesh.physical_names() == mesh.field_data
    # relabelling keeps every element's coordinates and the group nodes
    base = box_tet10(0.3, 0.2, 0.2, 0.1, force_points=[(0.3, 0.1, 0.1)],
                     fix_points=[(0, 0, 0), (0, 0.2, 0.2)])
    assert base.structured is not None and mesh.structured is None
    for k in base.cells:
        np.testing.assert_array_equal(mesh.points[mesh.cells[k]], base.points[base.cells[k]])
