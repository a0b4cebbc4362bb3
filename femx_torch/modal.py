"""Modal analysis: generalized symmetric eigensolves on (K, M) (port of
femx/modal.py).

- dense path: Cholesky reduction M = L L^T, eigh(L^-1 K L^-T);
- diagonal-mass path: eigh(M^-1/2 K M^-1/2) (lumped mass is diagonal);
- large matrix-free paths: shift-invert Lanczos with preconditioned-CG
  inner solves (the production solver), and LOBPCG (torch.lobpcg on the
  operator, no matrix formed).

Output semantics are the reference's: eigenvalues filtered to > 1e-6,
omega = sqrt(lambda) rad/s, mode shapes scattered to full DOF vectors
(BeamSolver.py:446-455). The k x k Ritz algebra runs in host numpy float64;
the tall products stay torch matmuls on the vectors' device (TF32 is off,
femx_torch.config).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from femx_torch.config import resolve_device, torch_dtype
from femx_torch.solve.cg import pcg

_SEED = 0  # the default start-vector seed (femx: PRNGKey(0))


class ModalResult(NamedTuple):
    omega: torch.Tensor  # natural frequencies, rad/s, ascending
    modes: torch.Tensor  # (ndof, n_modes) mass-orthonormal mode shapes
    iterations: Optional[int] = None  # solver iterations (None: direct)
    # per Lanczos step, the inner CG iterations (when the inner solve is
    # the solver_state pcg; None otherwise)
    inner_iterations: Optional[List[int]] = None


def generalized_eigh_dense(K: torch.Tensor, M: torch.Tensor):
    """All eigenpairs of K v = lambda M v for dense SPD M (Cholesky reduce)."""
    L = torch.linalg.cholesky(M)
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Ktil = Linv @ K @ Linv.T
    Ktil = 0.5 * (Ktil + Ktil.T)
    lam, y = torch.linalg.eigh(Ktil)
    return lam, Linv.T @ y


def generalized_eigh_diag_mass(K: torch.Tensor, m_diag: torch.Tensor):
    """Eigenpairs for diagonal M (lumped mass): eigh(M^-1/2 K M^-1/2)."""
    s = 1.0 / torch.sqrt(m_diag)
    Ktil = K * s[:, None] * s[None, :]
    Ktil = 0.5 * (Ktil + Ktil.T)
    lam, y = torch.linalg.eigh(Ktil)
    return lam, y * s[:, None]


def modal_dense(K, M, fixed_dofs, n_modes: Optional[int] = None, lam_min: float = 1e-6,
                device=None) -> ModalResult:
    """Host-partitioned modal solve on the free-free blocks (reference
    semantics, BeamSolver.py:440-455, with a symmetric solver and true
    eigenvectors); the eigensolve runs on `device`. Raises if M_ff is
    singular."""
    dev = resolve_device(device)
    K = np.asarray(K)
    M = np.asarray(M)
    ndof = K.shape[0]
    free = np.setdiff1d(np.arange(ndof), np.asarray(fixed_dofs, dtype=np.int64))
    K_ff = torch.as_tensor(K[np.ix_(free, free)], device=dev)
    M_ff = M[np.ix_(free, free)]
    diag = np.diag(M_ff)
    if np.all(np.abs(M_ff - np.diag(diag)) < 1e-300):
        if np.any(diag <= 0):
            raise np.linalg.LinAlgError(
                "Mass matrix is singular (zero lumped mass on a free DOF)")
        lam, v = generalized_eigh_diag_mass(K_ff, torch.as_tensor(diag, device=dev))
    else:
        lam, v = generalized_eigh_dense(K_ff, torch.as_tensor(M_ff, device=dev))
    lam = lam.cpu().numpy()
    v = v.cpu().numpy()
    valid = lam > lam_min
    lam, v = lam[valid], v[:, valid]
    if n_modes is not None:
        lam, v = lam[:n_modes], v[:, :n_modes]
    full = np.zeros((ndof, v.shape[1]))
    full[free, :] = v
    return ModalResult(omega=torch.as_tensor(np.sqrt(lam), device=dev),
                       modes=torch.as_tensor(full, device=dev))


class _MatrixFree(torch.Tensor):
    """An (n, n) stand-in for torch.lobpcg's A: it holds no storage, and
    torch.matmul(A, X) applies `fn` to X; every other torch function sees
    a plain tensor's metadata."""

    @staticmethod
    def __new__(cls, fn, n, dtype, device):
        t = torch.Tensor._make_wrapper_subclass(cls, (n, n), dtype=dtype, device=device)
        t._fn = fn
        return t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.matmul:
            return args[0]._fn(args[1])
        if func is torch.lobpcg:
            # the algorithm's body, with this class' functions still routed
            # here (the default below would turn them off for the whole call)
            from torch._lobpcg import _lobpcg

            return _lobpcg(*args, **(kwargs or {}))
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(f"{func} on a matrix-free operator")


def modal_lobpcg(
    K_apply: Callable[[torch.Tensor], torch.Tensor],
    m_diag,
    free_mask,
    n_modes: int = 10,
    maxiter: int = 300,
    tol: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> ModalResult:
    """Smallest modes of the large matrix-free generalized problem.

    With the diagonal mass, A = M^-1/2 K M^-1/2 restricted to free DOFs;
    torch.lobpcg seeks the LARGEST eigenvalues of B = sigma*I - A, with
    sigma an upper spectral bound from power iteration, which are the
    smallest physical modes (femx's construction). Fixed DOFs sit at
    eigenvalue sigma of A, at the bottom of B's spectrum. K_apply maps an
    (ndof,) vector; random vectors come from `generator` (default seed 0).
    """
    dev = resolve_device(device)
    d = torch.as_tensor(np.asarray(m_diag), device=dev)
    s = torch.as_tensor(np.asarray(free_mask), dtype=d.dtype, device=dev)
    dm = torch.where(s > 0, 1.0 / torch.sqrt(torch.where(d > 0, d, torch.ones_like(d))),
                     torch.zeros_like(d))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(_SEED)

    def A_free(x):  # masked, mass-scaled operator on the columns of x
        xs = x * s[:, None]
        y = torch.stack([K_apply(xs[:, i] * dm) * dm for i in range(x.shape[1])], dim=1)
        return y * s[:, None]

    ndof = d.shape[0]
    v = torch.randn((ndof, 1), generator=generator, dtype=d.dtype, device=dev) * s[:, None]
    for _ in range(20):
        v = A_free(v)
        v = v / torch.linalg.norm(v)
    sigma = float((v * A_free(v)).sum()) * 1.05 + 1.0

    def B(x):
        Ax = A_free(x) + sigma * (1.0 - s)[:, None] * x
        return sigma * x - Ax

    X0 = torch.randn((ndof, n_modes), generator=generator, dtype=d.dtype,
                     device=dev) * s[:, None]
    steps = []
    theta, y = torch.lobpcg(_MatrixFree(B, ndof, d.dtype, dev), X=X0, niter=maxiter,
                            tol=tol, largest=True,
                            tracker=lambda w: steps.append(int(w.ivars["istep"])))
    lam = sigma - theta
    order = torch.argsort(lam)
    lam = lam[order]
    modes = y[:, order] * dm[:, None]
    valid = lam > 1e-6
    omega = torch.sqrt(torch.where(valid, lam, torch.ones_like(lam))) * valid
    return ModalResult(omega=omega, modes=modes, iterations=max(steps, default=0))


def _lanczos_orth_step(V: torch.Tensor, w: torch.Tensor, j: int):
    """Two-pass classical Gram-Schmidt of w against all rows of V (rows past
    the current iterate are zero, so they project to nothing). Returns the
    orthogonalized w, alpha = <v_j, w_in> (with the second-pass correction)
    and beta = ||w_out||, both 0-d tensors."""
    p1 = V @ w
    w = w - V.T @ p1
    p2 = V @ w
    w = w - V.T @ p2
    return w, p1[j] + p2[j], torch.linalg.norm(w)


def _masked_normal(generator, ndof, dtype, device, s):
    return torch.randn(ndof, generator=generator, dtype=dtype, device=device) * s


def modal_shift_invert(
    K_solve: Optional[Callable[[torch.Tensor], torch.Tensor]],
    m_diag,
    free_mask,
    n_modes: int = 10,
    tol: float = 1e-8,
    maxiter: int = 100,
    generator: Optional[torch.Generator] = None,
    dtype=None,
    solver_state=None,
    v0=None,
    device=None,
) -> ModalResult:
    """Shift-invert Lanczos for the smallest modes of K v = lambda M v.

    With diagonal (lumped) mass M = D^2 the generalized problem symmetrizes
    to A = D^-1 K D^-1; Lanczos runs on the inverted operator
    T = A^-1 = D K^-1 D (each apply one inner K-solve), whose largest
    eigenvalues mu = 1/lambda are the smallest physical modes. Full
    reorthogonalization (two classical Gram-Schmidt passes against the
    whole basis) keeps the basis orthonormal in float32; the basis is a
    preallocated (maxiter, ndof) tensor written in place. Each iteration
    reads alpha and beta on the host.

    Args:
      K_solve: b -> approx K^-1 b on free DOFs (fixed DOFs pass through; D
        zeroes them). May be None when solver_state is given.
      m_diag: (ndof,) lumped mass diagonal (K_solve's DOF layout), host.
      free_mask: (ndof,) 1.0 free / 0.0 fixed, host.
      tol: Lanczos convergence: beta_k |s_k| <= tol * mu for each of the
        first n_modes Ritz pairs.
      generator: the start and restart vectors' torch.Generator (default:
        seed 0 on the device).
      dtype: the basis' dtype (default: solver_state's operator's, else
        float64).
      solver_state: (op, precond, inner_tol, inner_maxiter): the inner solve
        is pcg(op.apply_constrained, b, precond, inner_tol, inner_maxiter),
        and the result records each solve's iterations.
      v0: optional start vector (host or tensor); it is masked and
        normalized (the default draws one from `generator`).
      device: where the basis lives (default: solver_state's operator, else
        CUDA).
    Returns:
      ModalResult: omega (rad/s, ascending) and mass-orthonormal mode shapes
      (v^T M v = I), fixed DOFs exactly zero.
    """
    inner_its: Optional[List[int]] = None
    if solver_state is not None:
        s_op, s_pre, s_tol, s_maxit = solver_state
        inner_its = []
        dev = s_op.device if device is None else resolve_device(device)
        if dtype is None:
            dtype = torch_dtype(s_op.dtype)

        def K_solve(b):
            r = pcg(s_op.apply_constrained, b, M_inv_diag=s_pre, tol=s_tol, maxiter=s_maxit)
            inner_its.append(r.iterations)
            return r.x
    else:
        dev = resolve_device(device)
    s_host = np.asarray(free_mask, dtype=np.float64)
    m_host = np.asarray(m_diag, dtype=np.float64)
    d_host = np.sqrt(np.where(m_host > 0, m_host, 0.0)) * s_host
    dinv_host = np.where(d_host > 0, 1.0 / np.where(d_host > 0, d_host, 1.0), 0.0)
    ndof = m_host.shape[0]
    dtype = torch.float64 if dtype is None else torch_dtype(dtype)
    d = torch.tensor(d_host, dtype=dtype, device=dev)
    s = torch.tensor(s_host, dtype=dtype, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(_SEED)

    V = torch.zeros((maxiter, ndof), dtype=dtype, device=dev)
    v = (_masked_normal(generator, ndof, dtype, dev, s) if v0 is None
         else torch.tensor(np.asarray(v0), dtype=dtype, device=dev) * s)
    V[0] = v / torch.linalg.norm(v)

    alphas: list = []
    betas: list = []  # betas[j] links v_j -> v_{j+1}
    k_done = 0
    restarts = 0
    S = mu = None
    for j in range(maxiter):
        w = d * K_solve(d * V[j])
        w, alpha, beta = _lanczos_orth_step(V, w, j)
        if j + 1 < maxiter:
            V[j + 1] = w / torch.where(beta > 0, beta, torch.ones_like(beta))
        alphas.append(float(alpha))
        betas.append(float(beta))
        k_done = j + 1

        # Ritz decomposition of the k x k tridiagonal (host, tiny)
        Tk = np.diag(np.array(alphas))
        if k_done > 1:
            off = np.array(betas[:k_done - 1])
            Tk += np.diag(off, 1) + np.diag(off, -1)
        mu, S = np.linalg.eigh(Tk)
        mu, S = mu[::-1], S[:, ::-1]  # descending: smallest lambda first
        if k_done >= n_modes:
            res = betas[-1] * np.abs(S[-1, :n_modes])
            if np.all(res <= tol * np.maximum(np.abs(mu[:n_modes]), 1e-300)):
                break

        scale = max(abs(a) for a in alphas) + 1e-300
        if betas[-1] <= 1e-12 * scale:
            # happy breakdown: restart with a fresh vector orthogonal to V
            restarts += 1
            if restarts > 3 or k_done + 1 >= maxiter:
                break
            vnew, _, nrm = _lanczos_orth_step(
                V, _masked_normal(generator, ndof, dtype, dev, s), j)
            V[j + 1] = vnew / nrm
            betas[-1] = 0.0
        elif j + 1 >= maxiter:
            break

    n_keep = min(n_modes, k_done)
    S_top = torch.as_tensor(np.ascontiguousarray(S[:, :n_keep]), dtype=dtype, device=dev)
    W = V[:k_done].T @ S_top  # (ndof, n_keep) Ritz vectors of T
    modes = W * torch.tensor(dinv_host, dtype=dtype, device=dev)[:, None]
    lam = 1.0 / np.maximum(mu[:n_keep], 1e-300)
    # the reference's lam filter (BeamSolver.py:448), and mu > 0: inexact
    # inner solves can give a non-positive Ritz value whose 1/mu would pass
    # the lam filter as an astronomically large frequency
    valid = (mu[:n_keep] > 0) & (lam > 1e-6)
    omega = np.sqrt(np.where(valid, lam, 1.0)) * valid
    return ModalResult(omega=torch.as_tensor(omega, dtype=dtype, device=dev), modes=modes,
                       iterations=k_done, inner_iterations=inner_its)


def _vec(x, like: torch.Tensor, dtype) -> torch.Tensor:
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                           dtype=dtype, device=like.device)


def eig_residuals(k_apply, m_diag, omega, modes: torch.Tensor) -> torch.Tensor:
    """Per-mode relative algebraic eigen-residuals for the pencil (K, M):
    eta_i = ||K v_i - lam_i M v_i||_{M^-1} / (lam_i ||v_i||_M), lam_i =
    omega_i^2, in m_diag's dtype. For a symmetric pencil some exact
    eigenvalue lam* has |lam_i - lam*| / lam_i <= eta_i. First order in the
    mode-shape error: with f32 inner solves it saturates (femx's caveat);
    shift_invert_refine gives the sharp bound."""
    m = _vec(m_diag, modes, None)
    m_safe = torch.where(m > 0, m, torch.ones_like(m))
    sq = torch.sqrt(m_safe)
    lam = _vec(omega, modes, m.dtype) ** 2
    etas = []
    for i in range(modes.shape[1]):
        v = modes[:, i].to(m.dtype)
        r = k_apply(v) - lam[i] * m * v
        num = torch.linalg.norm(r / sq)
        den = lam[i] * torch.linalg.norm(sq * v)
        etas.append(num / torch.where(den > 0, den, torch.ones_like(den)))
    return torch.stack(etas)


def rayleigh_error_estimates(k_apply, m_diag, omega, modes: torch.Tensor):
    """(rho, rel_err): the Rayleigh quotients (v^T K v)/(v^T M v) of the
    modes and their relative deviation from the solver's eigenvalues, a
    second-order-accurate error bar in the mode-shape error."""
    m = _vec(m_diag, modes, None)
    lam = _vec(omega, modes, m.dtype) ** 2
    rhos, errs = [], []
    for i in range(modes.shape[1]):
        v = modes[:, i].to(m.dtype)
        num = torch.dot(v, k_apply(v))
        den = torch.dot(v, m * v)
        rho = num / torch.where(den > 0, den, torch.ones_like(den))
        rhos.append(rho)
        errs.append(torch.abs(rho - lam[i]) / torch.where(lam[i] > 0, lam[i],
                                                          torch.ones_like(lam[i])))
    return torch.stack(rhos), torch.stack(errs)


def shift_invert_residuals(k_solve_accurate, m_diag, omega, modes: torch.Tensor):
    """Relative eigenvalue error bounds via the inverse-operator residual,
    in float64: in B = D K^-1 D (D = sqrt(M)) the modes give y = D v with
    B y ~ mu y, mu = 1/lam, and |lam - lam*| / lam ~ ||B y - mu y|| /
    (||y|| mu). One accurate solve per mode. Returns (eta_inv, mu)."""
    f64 = torch.float64
    m = _vec(m_diag, modes, f64)
    d = torch.sqrt(torch.where(m > 0, m, torch.zeros_like(m)))
    lam = _vec(omega, modes, f64) ** 2
    etas, mus = [], []
    for i in range(modes.shape[1]):
        v = modes[:, i].to(f64)
        y = d * v
        ynorm = torch.linalg.norm(y)
        mu = 1.0 / torch.where(lam[i] > 0, lam[i], torch.ones_like(lam[i]))
        By = d * k_solve_accurate(m * v).to(f64)
        eta_abs = torch.linalg.norm(By - mu * y) / torch.where(ynorm > 0, ynorm,
                                                               torch.ones_like(ynorm))
        etas.append(eta_abs / mu)
        mus.append(mu)
    return torch.stack(etas), torch.stack(mus)


def shift_invert_refine(k_solve_accurate, m_diag, modes: torch.Tensor):
    """One inverse-iteration step + Rayleigh-Ritz through the inverse
    operator, with per-mode Ritz bounds (femx.modal.shift_invert_refine).

    W = K^-1 M V damps the noise component at eigenvalue lam_j by
    lam_i/lam_j; Rayleigh-Ritz on span(W) in B = D K^-1 D (D = sqrt(lumped
    M)) rotates within the subspace, which clustered modes need. Cost: 2k
    accurate solves, each on a unit-norm right-hand side (K^-1 is
    homogeneous; this keeps CG's intermediates in range). The tall Gram
    products are float64 torch matmuls on the modes' device; the k x k
    algebra is host numpy float64.

    Returns (omega_ref, eta, modes_ref) as float64 tensors: refined angular
    frequencies (ascending), first-order relative eigenvalue error bounds
    eta_i = ||B y_i - th_i y_i|| / (||y_i|| th_i), and the refined shapes.
    """
    f64 = torch.float64
    m = _vec(m_diag, modes, f64)
    d = torch.sqrt(torch.where(m > 0, m, torch.zeros_like(m)))
    V = modes.to(f64)
    k = V.shape[1]

    def solve_normed(b):
        nb = float(torch.linalg.norm(b))
        sc = nb if nb > 0 else 1.0
        return sc * k_solve_accurate(b / sc).to(f64)

    W = torch.stack([solve_normed(m * V[:, i]) for i in range(k)], dim=1)
    Y = d[:, None] * W
    BY = torch.stack([d * solve_normed(m * W[:, i]) for i in range(k)], dim=1)
    G = (Y.T @ Y).cpu().numpy()
    H = (Y.T @ BY).cpu().numpy()
    H = 0.5 * (H + H.T)  # symmetric in exact arithmetic
    # generalized symmetric Ritz: H c = th G c via G^-1/2 whitening
    gw, gv = np.linalg.eigh(G)
    gw = np.maximum(gw, gw[-1] * 1e-14)
    Gih = gv @ np.diag(gw ** -0.5) @ gv.T
    th, C = np.linalg.eigh(Gih @ H @ Gih)
    order = np.argsort(-th)  # descending mu = ascending frequency
    th = th[order]
    Cd = torch.as_tensor((Gih @ C)[:, order], device=V.device)  # G-orthonormal
    # refined Ritz residuals from the images already computed: BY c - th Y c
    Yc = Y @ Cd
    Rc = BY @ Cd - Yc * torch.as_tensor(th, device=V.device)[None, :]
    eta = (torch.linalg.norm(Rc, dim=0).cpu().numpy()
           / np.maximum(torch.linalg.norm(Yc, dim=0).cpu().numpy(), 1e-300)) / np.abs(th)
    omega_ref = np.sqrt(1.0 / np.maximum(th, 1e-300))
    return (torch.as_tensor(omega_ref, device=V.device), torch.as_tensor(eta, device=V.device),
            W @ Cd)


def solid_modal_structured(
    op,
    preconditioner,
    rho: float,
    n_modes: int = 10,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 200,
    tol: float = 1e-6,
    maxiter: int = 100,
    generator: Optional[torch.Generator] = None,
    v0=None,
) -> ModalResult:
    """First n_modes natural frequencies/shapes of a structured solid box:
    the operator's HRZ-lumped mass, PCG inner solves with `preconditioner`
    (a StructuredMultigrid, or any r -> M^-1 r) and shift-invert Lanczos,
    all in the operator's internal DOF layout and dtype, on its device (use
    op.to_global on the modes)."""
    return modal_shift_invert(
        None, op.lumped_mass_diagonal(rho), op.free_mask_host, n_modes=n_modes, tol=tol,
        maxiter=maxiter, generator=generator,
        solver_state=(op, preconditioner, float(inner_tol), int(inner_maxiter)), v0=v0)


def reference_qr_eigensolve(A: np.ndarray, max_iter: int = 1000, tol: float = 1e-9):
    """Reference-compat eigensolver: unshifted QR iteration with a diagonal
    stagnation test, returning (sorted eigenvalues, accumulated Q columns)
    as the reference's `qr_algorithm` does (BeamSolver.py:467-481). Host
    numpy; kept for cross-validation only."""
    A_k = np.asarray(A).copy()
    n = A_k.shape[0]
    V = np.eye(n)
    A_k_new = A_k
    for _ in range(max_iter):
        Q, R = np.linalg.qr(A_k)
        A_k_new = R @ Q
        V = V @ Q
        if np.allclose(np.diag(A_k), np.diag(A_k_new), atol=tol):
            break
        A_k = A_k_new
    lam = np.diag(A_k_new)
    order = np.argsort(lam)
    return lam[order], V[:, order]
