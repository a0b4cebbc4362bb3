"""SolidReactionAnalysis(devices=4) on the upstream's box, four gloo ranks
on the CPU, held to the benchmark's plain reference (benchmark/reference.py:
torch and numpy only, nothing of the program): its answers against a
float64 sparse direct solve of the reference's own assembled stiffness, and
the numbers the benchmark's `correct` compares.

The box is the upstream's 0.8 x 0.2 x 0.8 m at the source's own 0.05 m:
16 x 4 x 16 cells, 29,403 DOF; 16 % (2 x 4) = 0, so the slabs need no
ghost padding and the first coarsening is uniform, as at the benchmark's
12.9M-DOF scale. Loads are 1-3 point loads of 500-5,000 N in a random
direction at lattice nodes of the top face, drawn from the test's seed."""

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl

import femx_torch
from femx_torch.parallel import launch, rank_checks

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmark"))
import reference  # noqa: E402

DIMS = (0.8, 0.2, 0.8)
H = 0.05
SUPPORTS = [(0.0, 0.0, 0.0), (0.0, 0.0, 0.8), (0.8, 0.0, 0.0), (0.8, 0.0, 0.8)]
CONFIG = {"box": {"dims_m": list(DIMS)}, "mesh_size_m": H,
          "material": {"E_pa": 2e11, "nu": 0.3},
          "supports": [{"x": x, "y": y, "z": z} for x, y, z in SUPPORTS]}
TIMEOUT = 240.0
# CG stops at a relative residual of 1e-8 (the benchmark configuration's
# cg_tol), which bounds the error left in u only through K's condition
# number; on this box it read 8.2e-10 to 1.7e-8 of |u| over twelve answers
# of three seeds, so 1e-6 holds the answers to the float64 solution with a
# margin of 60 or more, while an answer off by a percent, or a float32
# solve, fails it
U_RTOL = 1e-6
RESIDUAL_LIMIT = 1.01e-8  # benchmark/limits/box13m-struct-4gpu.json


def _loads(rng):
    """1-3 point loads at distinct lattice nodes of the top face (y = 0.2),
    500-5,000 N each, in a random direction."""
    n = int(rng.integers(1, 4))
    half = H / 2
    nx, nz = round(DIMS[0] / half), round(DIMS[2] / half)
    picks = rng.choice((nx + 1) * (nz + 1), size=n, replace=False)
    out = []
    for p in picks:
        d = rng.standard_normal(3)
        f = rng.uniform(500.0, 5000.0) * d / np.linalg.norm(d)
        out.append({"x": (p // (nz + 1)) * half, "y": DIMS[1], "z": (p % (nz + 1)) * half,
                    "fx": float(f[0]), "fy": float(f[1]), "fz": float(f[2])})
    return out


def _program(loads):
    return [{"force_x": p["fx"], "force_y": p["fy"], "force_z": p["fz"],
             "force_x_pstn": p["x"], "force_y_pstn": p["y"], "force_z_pstn": p["z"]}
            for p in loads]


class Direct:
    """The reference's K, assembled and factored once in float64."""

    def __init__(self):
        self.model = reference.BoxModel(CONFIG)
        m = self.model
        ke, d = m.Ke.numpy(), m.dofs.numpy()
        rows, cols = np.repeat(d, 30, axis=1).ravel(), np.tile(d, (1, 30)).ravel()
        K = sp.csr_matrix((ke.ravel(), (rows, cols)), shape=(m.ndof, m.ndof))
        self.free = np.ones(m.ndof, dtype=bool)
        self.free[m.fixed] = False
        self.lu = spl.splu(K[self.free][:, self.free].tocsc())

    def solve(self, loads):
        u = np.zeros(self.model.ndof)
        u[self.free] = self.lu.solve(self.model.loads(loads)[self.free])
        return u


@pytest.fixture(scope="module")
def direct():
    return Direct()


@pytest.fixture(scope="module", params=[11, 2 ** 31 + 7], ids=["seed11", "seed2e31"])
def run(request):
    """The analysis on four ranks with its load and three more cases, all
    drawn from the seed; the mesh embeds every load point."""
    rng = np.random.default_rng(request.param)
    first, cases = _loads(rng), [_loads(rng) for _ in range(3)]
    points = sorted({(p["x"], p["y"], p["z"]) for c in [first] + cases for p in c})
    mesh = femx_torch.box_tet10(*DIMS, H, force_points=points, fix_points=SUPPORTS)
    assert mesh.structured is not None  # every point is a lattice node
    fixes = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x, y, z in SUPPORTS]
    kw = dict(E=2e11, v=0.3, dtype=np.float32, cg_tol=1e-8, devices=4, device="cpu")
    out = launch(rank_checks.solid_analysis, 4, mesh, _program(first), fixes, kw,
                 [_program(c) for c in cases], device="cpu", timeout=TIMEOUT)
    return {"first": first, "cases": cases, "points": np.asarray(mesh.points), "out": out}


def _check(direct, loads, u_program, points):
    m = direct.model
    u = m.to_reference(u_program, m.order_of(points))
    want = direct.solve(loads)
    err = np.linalg.norm(u - want) / np.linalg.norm(want)
    assert err <= U_RTOL, err
    got = m.judge(loads, u)
    assert got["residual"] <= RESIDUAL_LIMIT, got
    assert got["support"] == 0.0


def test_devices4_analysis_matches_the_reference(direct, run):
    info = run["out"]["solve_info"]
    assert info["devices"] == 4 and info["backend"] == "gloo"
    assert info["method"].startswith("distributed_halo_mg_pcg[4xz]")
    assert info["padded_nz"] == 16
    _check(direct, run["first"], run["out"]["u"], run["points"])


def test_devices4_cases_match_the_reference(direct, run):
    infos = run["out"]["case_solve_info"]
    assert len(infos) == 3 and all(i["converged"] for i in infos)
    for loads, u in zip(run["cases"], run["out"]["cases"]):
        _check(direct, loads, u, run["points"])
