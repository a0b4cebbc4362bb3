"""The port's host-only counterparts against femx's: the native .msh
tokenizer (femx/_native.py), the meshio fallback of read_msh
(femx/mesh/msh_io.py:434, against a stub: meshio is absent here) and the
multigrid disk cache (femx/solve/multigrid.py:42-140).

Tolerances: the tokenizer and the readers exactly (bitwise); a V-cycle
from a cache hit bitwise equal to the cold build's, and one from femx's
own cache file to 1e-12 of the largest entry of the cold build's (femx
computes its levels' inverse blocks in jax).
"""

import io
import sys
import types

import numpy as np
import pytest
import torch

from femx import _native as fx_native
from femx.mesh import read_msh as fx_read_msh
from femx.solve import multigrid as fx_mg

import femx_torch
from femx_torch import _native
from femx_torch.mesh import read_msh, write_msh
from femx_torch.solve import multigrid as pt_mg

TEXT = " 1 2.5 -3e4\n7 0.125\t42 6.02214076e23 -0.0 1e-300 \n 123456789012345 "


def test_native_tokenizer_matches_femx_and_builds_in_the_port_build_dir():
    assert _native.native_available()
    assert _native.library_path().parent == femx_torch.build.BUILD_DIR
    np.testing.assert_array_equal(_native.parse_numbers(TEXT), fx_native.parse_numbers(TEXT))
    assert _native.parse_numbers("  \n ").size == 0
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000)
    text = " ".join(repr(float(v)) for v in vals)
    np.testing.assert_array_equal(_native.parse_numbers(text), vals)
    with pytest.raises(ValueError):
        _native.parse_numbers("1 2 x3")


def test_native_tokenizer_without_a_compiler(monkeypatch, tmp_path):
    """No g++: the numpy path, with the same numbers."""
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "library_path", lambda: tmp_path / "libfemx_native-x.so")
    monkeypatch.setattr(_native.shutil, "which", lambda _name: None)
    assert not _native.native_available()
    np.testing.assert_array_equal(_native.parse_numbers(TEXT), fx_native.parse_numbers(TEXT))
    assert not any(tmp_path.iterdir())


def test_read_msh_matches_femx_through_the_tokenizer():
    mesh = femx_torch.box_tet10(0.4, 0.2, 0.2, 0.05, force_points=[(0.4, 0.1, 0.1)],
                                fix_points=[(0, 0, 0)])
    buf = io.StringIO()
    write_msh(buf, mesh)
    a, b = read_msh(buf.getvalue()), fx_read_msh(buf.getvalue())
    np.testing.assert_array_equal(a.points, np.asarray(b.points))
    assert set(a.cells) == set(b.cells)
    for k in a.cells:
        np.testing.assert_array_equal(a.cells[k], np.asarray(b.cells[k]))
        np.testing.assert_array_equal(a.cell_physical[k], np.asarray(b.cell_physical[k]))
    assert a.field_data == {k: tuple(v) for k, v in b.field_data.items()}


class _Block:
    def __init__(self, t, d):
        self.type, self.data = t, d


def _meshio_stub(mesh):
    """What meshio.read returns for `mesh`'s gmsh file: Tet10 blocks in
    meshio's (VTK) node order, nodes 8 and 9 of gmsh's swapped."""
    cells = [_Block(k, np.asarray(v)[:, [0, 1, 2, 3, 4, 5, 6, 7, 9, 8]] if k == "tetra10"
                    else np.asarray(v)) for k, v in mesh.cells.items()]
    return types.SimpleNamespace(
        points=np.asarray(mesh.points), cells=cells,
        cell_data_dict={"gmsh:physical": {k: np.asarray(v)
                                          for k, v in mesh.cell_physical.items()}},
        field_data={k: np.asarray(v) for k, v in mesh.field_data.items()})


def test_meshio_fallback_keeps_gmsh_tet10_order(tmp_path, monkeypatch):
    """A path the native reader rejects goes through meshio when it is
    installed (a stub here); the port puts Tet10 nodes 8 and 9 back in
    gmsh's order, which its native reader keeps, where femx's fallback
    leaves meshio's."""
    mesh = femx_torch.box_tet10(0.2, 0.1, 0.1, 0.05, fix_points=[(0, 0, 0)])
    bogus = tmp_path / "mesh.vtk"
    bogus.write_text("# vtk DataFile Version 3.0\n")
    monkeypatch.delitem(sys.modules, "meshio", raising=False)
    with pytest.raises(ValueError):
        read_msh(str(bogus))
    fake = types.ModuleType("meshio")
    fake.read = lambda path: _meshio_stub(mesh)
    monkeypatch.setitem(sys.modules, "meshio", fake)
    got = read_msh(str(bogus))
    np.testing.assert_array_equal(got.cells["tetra10"], mesh.cells["tetra10"])
    np.testing.assert_array_equal(got.cells["vertex"], mesh.cells["vertex"])
    np.testing.assert_array_equal(got.cell_physical["tetra10"], mesh.cell_physical["tetra10"])
    assert got.field_data == mesh.field_data
    fx = fx_read_msh(str(bogus))
    np.testing.assert_array_equal(np.asarray(fx.cells["tetra10"]),
                                  np.asarray(mesh.cells["tetra10"])[:, [0, 1, 2, 3, 4, 5, 6, 7,
                                                                        9, 8]])
    np.testing.assert_array_equal(got.points, np.asarray(fx.points))
    # the native reader of the same mesh's .msh keeps gmsh's order too
    path = tmp_path / "mesh.msh"
    write_msh(str(path), mesh)
    np.testing.assert_array_equal(read_msh(str(path)).cells["tetra10"], got.cells["tetra10"])


def _cantilever(cells):
    mesh = femx_torch.box_tet10_from_cells(cells, (0.1, 0.1, 0.1))
    mask = np.ones(3 * mesh.num_nodes)
    for n in np.where(mesh.points[:, 2] < 1e-9)[0]:
        mask[3 * n:3 * n + 3] = 0.0
    return mesh.structured, mask


def test_mg_disk_cache_roundtrip_key_and_femx_files(tmp_path, monkeypatch):
    """femx's key and payload: a hit rebuilds the same V-cycle bitwise; a
    different mask misses; FEMX_MG_CACHE=0 writes nothing; femx's own cache
    file is a hit for the port; the default directory is the port's build
    directory, not ~/.cache/femx_mg."""
    monkeypatch.delenv("FEMX_MG_CACHE", raising=False)
    assert pt_mg._mg_cache_dir() == str(femx_torch.build.BUILD_DIR / "mg_cache")
    monkeypatch.setenv("FEMX_MG_CACHE", str(tmp_path / "pt"))
    info, mask = _cantilever((4, 4, 8))
    kw = dict(dtype=np.float32, coarse_dof_limit=3000, spacing=info.spacing, device="cpu")
    mg1 = pt_mg.StructuredMultigrid(None, info.n_cells, 2e11, 0.3, mask, **kw)
    entries = sorted((tmp_path / "pt").iterdir())
    assert len(entries) == 1 and not mg1.setup_cache_hit
    key = fx_mg._mg_cache_key(info.n_cells, info.spacing, 2e11, 0.3, None, np.float32, 2, 0.7,
                              3000, mask.reshape(2 * 4 + 1, 2 * 4 + 1, 2 * 8 + 1, 3))
    assert entries[0].name == f"hier_{key}.npz"
    mg2 = pt_mg.StructuredMultigrid(None, info.n_cells, 2e11, 0.3, mask, **kw)
    assert mg2.setup_cache_hit and mg1.omegas == mg2.omegas
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(mg1.fine_op.ndof)
                        .astype(np.float32))
    np.testing.assert_array_equal(mg1(r).numpy(), mg2(r).numpy())
    mask2 = mask.copy()
    mask2[3 * 40] = 0.0
    pt_mg.StructuredMultigrid(None, info.n_cells, 2e11, 0.3, mask2, **kw)
    assert len(list((tmp_path / "pt").iterdir())) == 2
    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    assert not pt_mg.StructuredMultigrid(None, info.n_cells, 2e11, 0.3, mask,
                                         **kw).setup_cache_hit
    assert len(list((tmp_path / "pt").iterdir())) == 2

    kw64 = dict(kw, dtype=np.float64)
    cold = pt_mg.StructuredMultigrid(None, info.n_cells, 2e11, 0.3, mask, **kw64)
    monkeypatch.setenv("FEMX_MG_CACHE", str(tmp_path / "fx"))
    fx_mg.StructuredMultigrid(None, info.n_cells, 2e11, 0.3, mask, dtype=np.float64,
                              coarse_dof_limit=3000, spacing=info.spacing)
    mg3 = pt_mg.StructuredMultigrid(None, info.n_cells, 2e11, 0.3, mask, **kw64)
    assert mg3.setup_cache_hit and len(list((tmp_path / "fx").iterdir())) == 1
    r64 = r.double()
    want = cold(r64).numpy()
    np.testing.assert_allclose(mg3(r64).numpy(), want, rtol=0, atol=np.abs(want).max() * 1e-12)
