"""femx_torch's modal slice == femx's on the same seeded inputs, on the CPU:
the Tet10 mass terms (rtol 1e-13), the structured lumped mass and diagonals
(1e-14), the Lanczos and Ritz pieces on identical inputs (1e-10),
modal_shift_invert with femx's start vector (omega 1e-8, equal iteration
count), modal_dense (1e-10), modal_lobpcg (1e-4) and
reference_qr_eigensolve (exact). SolidReactionAnalysis.modal on each
branch: tests/test_torch_modal_routes.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import femx
import femx_torch
from femx import modal as fx_modal
from femx.assembly_structured import StructuredSolidOperator as FxOp
from femx.assembly_structured import _cell_lumped_mass as fx_cell_mass
from femx.elements import tet10 as fx_tet10
from femx.solve.cg import pcg as fx_pcg
from femx_torch import modal as pt_modal
from femx_torch.assembly_structured import StructuredBlockJacobi
from femx_torch.assembly_structured import StructuredSolidOperator as PtOp
from femx_torch.assembly_structured import _cell_lumped_mass as pt_cell_mass
from femx_torch.elements import tet10 as pt_tet10
from femx_torch.solve.cg import pcg as pt_pcg

torch.set_num_threads(2)

E, NU, RHO = 2e11, 0.3, 7850.0
EDGES = [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)]


@pytest.fixture(autouse=True)
def _no_femx_disk_cache(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def _straight_tets(seed, n=6):
    rng = np.random.default_rng(seed)
    corners = rng.standard_normal((n, 4, 3)) * 0.3 + np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    mids = np.stack([0.5 * (corners[:, a] + corners[:, b]) for a, b in EDGES], axis=1)
    return np.concatenate([corners, mids], axis=1)  # (n, 10, 3)


# -- Tet10 mass terms ----------------------------------------------------------
def test_mass_hat_is_femx_s():
    np.testing.assert_array_equal(pt_tet10.MASS_HAT, fx_tet10.MASS_HAT)


@pytest.mark.parametrize("name", ["element_volume", "element_mass_consistent",
                                  "element_mass_lumped"])
def test_tet10_mass_terms_match_femx(name):
    """rtol 1e-13 on random straight tets, float64."""
    coords = _straight_tets(3)
    args = () if name == "element_volume" else (RHO,)
    want = getattr(fx_tet10, name)(jnp.asarray(coords), *args)
    got = getattr(pt_tet10, name)(torch.as_tensor(coords), *args)
    _close(got.numpy(), want, 1e-13)


# -- structured lumped mass and diagonals ----------------------------------------
def test_cell_lumped_mass_matches_femx():
    sp = (0.1, 0.2, 0.05)
    _close(pt_cell_mass(sp, RHO), fx_cell_mass(sp, RHO), 1e-14)


def _layered_ops(weighted):
    """(femx, port) f64 operators on (4, 3, 5) cells with a random mask and,
    when `weighted`, random x/y/z layer weights."""
    n, sp = (4, 3, 5), (0.1, 0.07, 0.05)
    fx = FxOp.from_lattice(n, sp, E, NU, dtype=np.float64)
    rng = np.random.default_rng(5)
    w = [rng.uniform(0.2, 1.0, c) for c in n] if weighted else [None] * 3
    if weighted:
        fx = dataclasses.replace(fx, x_weight=jnp.asarray(w[0]), y_weight=jnp.asarray(w[1]),
                                 z_weight=jnp.asarray(w[2]))
    mask = (rng.uniform(size=fx.ndof) > 0.1).astype(np.float64)
    fx = fx.with_free_mask(jnp.asarray(mask))
    pt = PtOp.from_host(PtOp.from_lattice(n, sp, E, NU, dtype=np.float64,
                                          device="cpu").Kcell_host,
                        n, fx.weight, spacing=sp, free_mask=mask, x_weight=w[0],
                        y_weight=w[1], z_weight=w[2], device="cpu")
    return fx, pt


@pytest.mark.parametrize("weighted", [False, True])
def test_lumped_mass_and_diagonals_match_femx(weighted):
    """lumped_mass_diagonal (layer weights included), diagonal and
    constrained_diagonal, internal layout: rtol 1e-14."""
    fx, pt = _layered_ops(weighted)
    _close(pt.lumped_mass_diagonal(RHO), fx.lumped_mass_diagonal(RHO), 1e-14)
    _close(pt.diagonal(), fx.diagonal(), 1e-14)
    _close(pt.constrained_diagonal(), fx.constrained_diagonal(), 1e-14)


# -- Lanczos and Ritz pieces on identical inputs ---------------------------------
@pytest.fixture(scope="module")
def pencil():
    """A random SPD K (60 x 60), a positive diagonal mass and 5 noisy
    approximations of its lowest modes."""
    rng = np.random.default_rng(11)
    n = 60
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    K = Q @ np.diag(np.geomspace(1.0, 1e4, n)) @ Q.T
    K = 0.5 * (K + K.T)
    m = rng.uniform(0.5, 2.0, n)
    s = 1.0 / np.sqrt(m)
    lam, y = np.linalg.eigh(K * s[:, None] * s[None, :])
    modes = (y * s[:, None])[:, :5]
    modes = modes + 1e-3 * rng.standard_normal(modes.shape) * np.abs(modes).max()
    return K, m, np.sqrt(lam[:5]), modes


def test_lanczos_orth_step_matches_femx():
    rng = np.random.default_rng(2)
    V = np.zeros((12, 50))
    V[:7] = np.linalg.qr(rng.standard_normal((50, 7)))[0].T
    w = rng.standard_normal(50)
    fw, fa, fb = fx_modal._lanczos_orth_step(jnp.asarray(V), jnp.asarray(w), 6)
    pw, pa, pb = pt_modal._lanczos_orth_step(torch.as_tensor(V), torch.as_tensor(w), 6)
    _close(pw.numpy(), fw, 1e-10)
    _close(float(pa), float(fa), 1e-10)
    _close(float(pb), float(fb), 1e-10)


def test_residual_estimates_match_femx(pencil):
    """eig_residuals, rayleigh_error_estimates, shift_invert_residuals:
    rtol 1e-10."""
    K, m, omega, modes = pencil
    Kinv = np.linalg.inv(K)
    fK, fKi = jnp.asarray(K), jnp.asarray(Kinv)
    pK, pKi = torch.as_tensor(K), torch.as_tensor(Kinv)
    fm, pm = jnp.asarray(modes), torch.as_tensor(modes)
    _close(pt_modal.eig_residuals(lambda v: pK @ v, m, omega, pm).numpy(),
           fx_modal.eig_residuals(lambda v: fK @ v, m, omega, fm), 1e-10)
    for p, f in zip(pt_modal.rayleigh_error_estimates(lambda v: pK @ v, m, omega, pm),
                    fx_modal.rayleigh_error_estimates(lambda v: fK @ v, m, omega, fm)):
        _close(p.numpy(), f, 1e-10)
    for p, f in zip(pt_modal.shift_invert_residuals(lambda b: pKi @ b, m, omega, pm),
                    fx_modal.shift_invert_residuals(lambda b: fKi @ b, m, omega, fm)):
        _close(p.numpy(), f, 1e-10)


def test_shift_invert_refine_matches_femx(pencil):
    K, m, omega, modes = pencil
    Kinv = np.linalg.inv(K)
    f_om, f_eta, f_modes = fx_modal.shift_invert_refine(
        lambda b: jnp.asarray(Kinv) @ b, m, jnp.asarray(modes))
    p_om, p_eta, p_modes = pt_modal.shift_invert_refine(
        lambda b: torch.as_tensor(Kinv) @ b, m, torch.as_tensor(modes))
    _close(p_om.numpy(), f_om, 1e-10)
    _close(p_eta.numpy(), f_eta, 1e-10)
    _close(p_modes.numpy(), f_modes, 1e-10)
    _close(p_om.numpy(), omega, 1e-6)  # and the refinement did its job


# -- modal_shift_invert: the cantilever box of tests/test_modal_structured.py ----
def _cantilever(pkg, Op, **kw):
    n_cells, h = (4, 4, 8), 0.05
    mesh = pkg.box_tet10(*(c * h for c in n_cells), mesh_size=h)
    op = Op.from_mesh(mesh, E, NU, dtype=np.float64, **kw)
    mask = np.ones(op.ndof)
    for node in np.where(mesh.points[:, 2] < 1e-9)[0]:
        mask[3 * node:3 * node + 3] = 0.0
    m_int = op.to_internal(mask)
    return op.with_free_mask(jnp.asarray(m_int) if pkg is femx else m_int)


def test_modal_shift_invert_matches_femx_with_its_start_vector():
    """f64, inner block-Jacobi PCG to 1e-10; the port gets femx's v0
    (PRNGKey(0) -> split -> normal, masked, normalized): omega rtol 1e-8
    and the same number of Lanczos iterations."""
    fop = _cantilever(femx, FxOp)
    pop = _cantilever(femx_torch, PtOp, device="cpu")
    m_int = fop.lumped_mass_diagonal(RHO)
    s = fop.free_mask_host
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    v0 = jax.random.normal(sub, (fop.ndof,), dtype=jnp.float64) * jnp.asarray(s)
    v0 = np.asarray(v0 / jnp.linalg.norm(v0))

    minv = fop.block_jacobi_preconditioner()

    @jax.jit
    def k_solve(b):
        return fx_pcg(fop.apply_constrained, b, M_inv_diag=minv, tol=1e-10, maxiter=2000).x

    want = fx_modal.modal_shift_invert(k_solve, m_int, s, n_modes=6, tol=1e-9, maxiter=80,
                                       dtype=fop.Kcell.dtype)
    got = pt_modal.modal_shift_invert(
        None, m_int, s, n_modes=6, tol=1e-9, maxiter=80, v0=v0,
        solver_state=(pop, StructuredBlockJacobi(pop), 1e-10, 2000))
    assert got.iterations == want.iterations
    assert len(got.inner_iterations) == got.iterations
    _close(got.omega.numpy(), want.omega, 1e-8)
    modes = got.modes.numpy()
    np.testing.assert_allclose(modes.T @ (m_int[:, None] * modes), np.eye(6), atol=1e-6)
    # a caller's own inner solve in place of solver_state: the same run
    bj = StructuredBlockJacobi(pop)
    again = pt_modal.modal_shift_invert(
        lambda b: pt_pcg(pop.apply_constrained, b, M_inv_diag=bj, tol=1e-10, maxiter=2000).x,
        m_int, s, n_modes=6, tol=1e-9, maxiter=80, v0=v0, device="cpu")
    assert again.iterations == got.iterations and again.inner_iterations is None
    torch.testing.assert_close(again.omega, got.omega, rtol=0, atol=0)


# -- modal_dense, modal_lobpcg, reference_qr_eigensolve --------------------------
@pytest.fixture(scope="module")
def lobpcg_box():
    """tests/test_modal_lobpcg.py's box: 675 DOF, the x=0 face clamped,
    uniform diagonal mass."""
    from femx.assembly import SolidOperator, assemble_dense, dof_map

    mesh = femx.box_tet10(0.4, 0.2, 0.2, 0.1)
    n = mesh.num_nodes
    C = fx_tet10.material_matrix(E, NU)
    op, _ = SolidOperator.from_mesh(mesh.points, mesh.cells["tetra10"], C)
    K = np.asarray(assemble_dense(op.element_stiffness(), dof_map(op.conn, 3), 3 * n))
    fixed_nodes = np.where(mesh.points[:, 0] < 1e-9)[0]
    fixed = (3 * fixed_nodes[:, None] + np.arange(3)).ravel()
    mask = np.ones(3 * n)
    mask[fixed] = 0
    m_diag = np.ones(3 * n) * RHO * (0.4 * 0.2 * 0.2) / n
    return mesh, C, K, fixed, mask, m_diag


@pytest.mark.parametrize("lumped", [True, False])
def test_modal_dense_matches_femx(lobpcg_box, lumped):
    """rtol 1e-10 with the lumped (diagonal) mass and with a consistent-like
    SPD mass (the Cholesky branch)."""
    _, _, K, fixed, _, m_diag = lobpcg_box
    M = np.diag(m_diag)
    if not lumped:
        off = 0.1 * np.sqrt(m_diag[:-1] * m_diag[1:])
        M = M + np.diag(off, 1) + np.diag(off, -1)
    want = fx_modal.modal_dense(K, M, fixed, n_modes=8)
    got = pt_modal.modal_dense(K, M, fixed, n_modes=8, device="cpu")
    _close(got.omega.numpy(), want.omega, 1e-10)
    for i in range(8):  # mode shapes up to sign
        a, b = got.modes.numpy()[:, i], np.asarray(want.modes)[:, i]
        _close(a * np.sign(a @ b), b, 1e-7)


def test_modal_lobpcg_matches_femx(lobpcg_box):
    """torch.lobpcg on the matrix-free operator (femx's test settings): the
    lowest 5 nonzero frequencies at rtol 1e-4 of femx's modal_dense on the
    same pencil (femx's own LOBPCG reaches it to 1e-8 in its test)."""
    from femx_torch.assembly import SolidOperator as PtSO

    mesh, C, K, fixed, mask, m_diag = lobpcg_box
    want = np.asarray(fx_modal.modal_dense(K, np.diag(m_diag), fixed, n_modes=5).omega)
    pop, _ = PtSO.from_mesh(mesh.points, mesh.cells["tetra10"], C, device="cpu")
    got = pt_modal.modal_lobpcg(pop.apply, m_diag, mask, n_modes=10, maxiter=600,
                                device="cpu")
    w = np.sort(got.omega.numpy())
    _close(w[w > 1.0][:5], want, 1e-4)
    assert got.iterations > 0


def test_reference_qr_eigensolve_is_femx_s():
    rng = np.random.default_rng(0)
    Q = np.linalg.qr(rng.normal(size=(20, 20)))[0]
    A = Q @ np.diag(np.arange(1.0, 21.0) ** 2) @ Q.T
    for got, want in zip(pt_modal.reference_qr_eigensolve(A, max_iter=5000, tol=1e-12),
                         fx_modal.reference_qr_eigensolve(A, max_iter=5000, tol=1e-12)):
        np.testing.assert_array_equal(got, want)


def test_modal_requires_solve():
    mesh = femx_torch.box_tet10(0.2, 0.2, 0.2, mesh_size=0.1)
    fa = femx_torch.SolidReactionAnalysis(mesh, [], [], E=E, v=NU, verbose=False,
                                          device="cpu")
    with pytest.raises(RuntimeError, match="solve"):
        fa.modal()
