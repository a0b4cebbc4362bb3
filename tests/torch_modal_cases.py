"""Cases and checks shared by tests/test_torch_modal_routes.py and
tests/test_torch_modal_mesh_files.py: SolidReactionAnalysis.modal of femx
and femx_torch on the same boxes, by branch."""

import numpy as np
import torch

import femx
import femx_torch
from femx_torch.mesh import relabel_nodes, write_msh

E, NU, RHO = 2e11, 0.3, 7850.0


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def _case(dims):
    """A box corner-fixed on its y=0 face with a load on top: (dims, fix,
    force)."""
    X, Y, Z = dims
    corners = [(0, 0, 0), (X, 0, 0), (0, 0, Z), (X, 0, Z)]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]
    force = [{"force_x": 0, "force_y": -500.0, "force_z": 0, "force_x_pstn": X / 2,
              "force_y_pstn": Y, "force_z_pstn": Z / 2}]
    return dims, corners, fix, force


BOX = _case((0.2, 0.2, 0.3))  # (4, 4, 6) cells, 3,159 DOF: two multigrid levels
SMALL = _case((0.2, 0.1, 0.15))  # 945 DOF, for the dense Cholesky route
N_MODES = 3


def _mesh(case):
    dims, corners, _, _ = case
    return femx_torch.box_tet10(*dims, mesh_size=0.05, fix_points=corners)


def write_files(tmp_path_factory):
    """Each box relabelled and written as .msh (the mesh-file routes)."""
    out = {}
    for name, case in (("box", BOX), ("small", SMALL)):
        mesh = _mesh(case)
        mesh = relabel_nodes(mesh, np.random.default_rng(0).permutation(mesh.num_nodes))
        out[name] = str(tmp_path_factory.mktemp("msh") / f"{name}.msh")
        write_msh(out[name], mesh)
    return out


# branch: (mesh source, constructor keywords, instance thresholds, the femx
# branch it is held to): femx's own branch on the same mesh and settings.
BRANCHES = {
    "structured_block_jacobi_pcg": ("box", {}, {}, "structured_block_jacobi_pcg"),
    "structured_multigrid_pcg": ("box", {"solver": "mg"}, {}, "structured_multigrid_pcg"),
    "tg_block_jacobi_pcg": ("box file", {}, {"DENSE_DOF_LIMIT": 2000}, "tg_block_jacobi_pcg"),
    "tg_lattice_mg_pcg": ("box file", {}, {"DENSE_DOF_LIMIT": 2000, "MG_DOF_THRESHOLD": 2000},
                          "tg_lattice_mg_pcg"),
    "block_jacobi_pcg": ("small file", {"solver": "cg"}, {}, "block_jacobi_pcg"),
    "dense_cholesky": ("small file", {}, {}, "dense_cholesky"),
}


def analysis(pkg, branch, files, **kw):
    src, ctor, limits, _ = BRANCHES[branch]
    name = src.split()[0]
    case = BOX if name == "box" else SMALL
    mesh = files[name] if src.endswith("file") else pkg.box_tet10(
        *case[0], mesh_size=0.05, fix_points=case[1])
    if pkg is femx_torch:
        kw["device"] = "cpu"
    fa = pkg.SolidReactionAnalysis(mesh, case[3], case[2], E=E, v=NU, verbose=False,
                                   **{**ctor, **kw})
    for k, v in limits.items():
        setattr(fa, k, v)
    return fa.run_simulation()


_FEMX_REFINED = {}


def femx_refined(branch, files):
    """femx's f64 refined omega (default Lanczos tolerances) on the branch
    `branch` is held to, computed once per module."""
    ref = BRANCHES[branch][3]
    if ref not in _FEMX_REFINED:
        fx = analysis(femx, ref, files)
        assert fx.solve_info["method"] == ref
        _FEMX_REFINED[ref] = np.asarray(fx.modal(n_modes=N_MODES, rho=RHO, refine=True).omega)
    return _FEMX_REFINED[ref]


def check_analysis_modal(branch, files):
    """f64: the default Lanczos, then the same refined, each at rtol 1e-6
    of femx's refined omega; the refined bounds, the iteration records and
    the modes' mass orthonormality in global order."""
    want = femx_refined(branch, files)
    pt = analysis(femx_torch, branch, files)
    assert pt.solve_info["method"] == branch
    got = pt.modal(n_modes=N_MODES, rho=RHO)
    close(got.omega.numpy(), want, 1e-6)
    assert pt.modal_info["refine_iterations"] is None
    assert len(pt.modal_info["inner_iterations"]) == pt.modal_info["iterations"]
    got = pt.modal(n_modes=N_MODES, rho=RHO, refine=True)
    close(got.omega.numpy(), want, 1e-6)
    assert np.all(pt.modal_error_bounds[:N_MODES] < 1e-4)
    assert len(pt.modal_info["refine_iterations"]) == 2 * N_MODES
    modes = got.modes.numpy()
    assert modes.shape == (3 * pt.num_nodes, N_MODES)
    mass = pt._lumped_mass(RHO)
    if hasattr(pt.operator, "to_global"):
        mass = pt.operator.to_global(mass)
    np.testing.assert_allclose(modes.T @ (mass[:, None] * modes), np.eye(N_MODES), atol=1e-6)


def check_f32_refined_modal(branch, files):
    """dtype=float32, refine=True: f32 Lanczos, then accurate solves as f64
    CG on the f64-assembled operator with the f32 preconditioner; the
    frequencies within 1e-6 of femx's float64 refined ones."""
    want = femx_refined(branch, files)
    pt = analysis(femx_torch, branch, files, dtype=np.float32)
    assert pt.solve_info["method"] == branch + "_mixed"
    got = pt.modal(n_modes=N_MODES, rho=RHO, refine=True)
    assert got.omega.dtype == torch.float32
    close(got.omega.double().numpy(), want, 1e-6)
