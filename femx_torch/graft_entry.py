"""Entry points of the port: the single-device forward step and the
multi-rank dry run (the counterparts of __graft_entry__.py's entry() and
dryrun_multichip(n)).

entry():             the flagship model's forward step (a Tetra10 solid
                     cantilever: Jacobians -> matrix-free K -> fixed-budget
                     block-Jacobi PCG) and example arguments, on the card.
dryrun_multichip(n): starts n ranks (femx_torch.parallel.launch) and runs
                     the element-parallel solve, the DOF-sharded apply and
                     batched load cases, the structured z-slab CG, and both
                     public devices=n pipelines, checking each; prints the
                     summary line femx's dry run prints.

    python -m femx_torch.graft_entry [n] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def _build_model(mesh_size: float, dtype, device):
    """Tiny flagship model: solid cantilever box fixed at x=0, tip load."""
    from femx_torch.assembly import SolidOperator
    from femx_torch.elements.tet10 import material_matrix
    from femx_torch.mesh import box_tet10

    mesh = box_tet10(0.4, 0.1, 0.1, mesh_size)
    conn = np.asarray(mesh.cells["tetra10"])
    points = np.asarray(mesh.points, dtype=dtype)
    op, _ = SolidOperator.from_mesh(points, conn, material_matrix(2e11, 0.3), dtype=dtype,
                                    device=device)
    mask = np.ones(3 * mesh.num_nodes, dtype=dtype)
    for n in np.where(mesh.points[:, 0] < 1e-9)[0]:
        mask[3 * n:3 * n + 3] = 0.0
    f = np.zeros(3 * mesh.num_nodes, dtype=dtype)
    f[3 * int(np.argmax(mesh.points[:, 0])) + 1] = -1000.0
    return op.with_free_mask(mask), points, conn, mask, f


def entry(device=None):
    """(fn, example_args): the single-device forward step in float32;
    fn(points_flat, f_vec, free_mask) -> (u, reactions)."""
    from femx_torch.assembly import SolidOperator
    from femx_torch.config import resolve_device
    from femx_torch.elements import tet10 as tet10_el
    from femx_torch.solve.cg import pcg

    dev = resolve_device(device)
    op, points, conn, mask, f = _build_model(0.05, np.float32, dev)
    conn_t = torch.as_tensor(conn, dtype=torch.int64, device=dev)
    C = op.C

    def forward_step(points_flat, f_vec, free_mask):
        """points -> Jacobians -> constrained matrix-free PCG -> (u, r)."""
        dN, wdet, _ = tet10_el.jacobians(points_flat.reshape(-1, 3)[conn_t])
        op_t = SolidOperator(conn=conn_t, dN=dN, wdet=wdet, C=C,
                             n_nodes=points_flat.shape[0] // 3, weight=op.weight,
                             free_mask=free_mask)
        res = pcg(op_t.apply_constrained, f_vec * free_mask,
                  M_inv_diag=op_t.block_jacobi_preconditioner(), tol=1e-5, maxiter=200)
        return res.x, op_t.apply(res.x)

    example_args = tuple(torch.as_tensor(a, device=dev) for a in (points.reshape(-1), f, mask))
    return forward_step, example_args


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 900.0) -> str:
    """One full multi-rank solve step over n ranks (tiny shapes); returns
    and prints the summary line. Raises if a stage fails its check."""
    from femx_torch.parallel import launch

    line = launch(_dryrun_rank, int(n_devices), str(device), device=device, timeout=timeout)
    print(line, flush=True)
    return line


def _dryrun_rank(device: str) -> str:
    from femx_torch.analysis import SolidReactionAnalysis
    from femx_torch.assembly_structured import StructuredBlockJacobi, StructuredSolidOperator
    from femx_torch.mesh import box_tet10, box_tet10_from_cells
    from femx_torch.mesh.core import Mesh
    from femx_torch.parallel import comm
    from femx_torch.parallel.ops import ShardedSolidOperator
    from femx_torch.parallel.structured import ShardedStructuredOperator
    from femx_torch.solve.cg import pcg

    n = comm.world_size()
    dev = comm.rank_device(comm.rank(), device)
    lead = comm.rank() == 0
    t_start = time.perf_counter()
    last = [t_start]

    def tick(name):
        now = time.perf_counter()
        if lead:
            print(f"[dryrun] {name}: {now - last[0]:.1f}s (total {now - t_start:.1f}s)",
                  flush=True)
        last[0] = now

    nb = 2 if (n % 2 == 0 and n >= 4) else 1
    ne = n // nb
    op, points, conn, mask, f = _build_model(0.05, np.float64, dev)
    sop = ShardedSolidOperator.create(op)
    f_t = torch.as_tensor(f, device=dev)
    mask_t = op.free_mask

    # 1) element-parallel constrained CG (one all_reduce per apply)
    u_dp = pcg(sop.apply_constrained, f_t * mask_t, tol=1e-8, maxiter=60).x
    tick("stage1 element-parallel PCG")

    # 2) DOF-sharded apply: all_gather + reduce_scatter, against the
    # replicated apply
    ndof = op.ndof
    pad = (-ndof) % n
    u_pad = torch.cat([u_dp, u_dp.new_zeros(pad)])
    chunk = u_pad.shape[0] // n
    r_sh = sop.apply_dof_sharded(u_pad[comm.rank() * chunk:(comm.rank() + 1) * chunk])
    r_full = comm.all_gather(r_sh).reshape(-1)[:ndof]
    r_ref = sop.apply(u_dp)
    err = float((r_full - r_ref).abs().max() / (r_ref.abs().max() + 1e-30))
    assert err < 1e-8, f"DOF-sharded apply mismatch: {err}"
    tick("stage2 DOF-sharded apply")

    # 3) load cases split over the ranks (no communication while solving)
    from femx_torch.parallel.ops import batched_solve_cg

    n_cases = max(2 * nb, 2)
    rhs = torch.stack([f_t * (i + 1.0) for i in range(n_cases)]) * mask_t
    ub = batched_solve_cg(op, rhs, None, tol=1e-8, maxiter=40)
    e = float((ub[1] - 2.0 * ub[0]).abs().max() / (ub[0].abs().max() + 1e-30))
    assert e < 1e-5, f"batched solve linearity violated: {e}"
    tick("stage3 batch-parallel cases")

    # 4) structured z-slab CG against the single-device CG
    smesh = box_tet10(0.2, 0.2, 1.6, 0.1)  # (2, 2, 16) cells
    st = StructuredSolidOperator.from_mesh(smesh, 2e11, 0.3, dtype=np.float64, device=dev)
    smask = np.ones(st.ndof)
    for node in np.where(smesh.points[:, 2] < 1e-9)[0]:
        smask[3 * node:3 * node + 3] = 0.0
    sf = np.zeros(st.ndof)
    tip = np.where(smesh.points[:, 2] > 1.6 - 1e-9)[0]
    sf[3 * tip + 1] = -100.0 / len(tip)
    st = st.with_free_mask(st.to_internal(smask))
    sf_int = torch.as_tensor(st.to_internal(sf * smask), device=dev)
    if 16 % n == 0:
        pre = StructuredBlockJacobi(st)
        x_sh = pcg(ShardedStructuredOperator(st).apply_constrained, sf_int, M_inv_diag=pre,
                   tol=1e-8, maxiter=60).x
        x_1d = pcg(st.apply_constrained, sf_int, M_inv_diag=pre, tol=1e-8, maxiter=60).x
        err = float((x_sh - x_1d).abs().max() / (x_1d.abs().max() + 1e-30))
        assert err < 1e-6, f"structured slab-sharded CG mismatch: {err}"
        structured_note = f"structured z-slab CG over {n} devices"
    else:
        structured_note = "structured psum path skipped (n_devices does not divide nz)"
    tick("stage4 structured z-slab CG")

    # 5) the public pipeline, structured, on a z cell count that needs
    # ghost padding (2n - 2 never divides 2n)
    pcells = (4, 4, max(2 * n - 2, 6))
    pmesh = box_tet10_from_cells(pcells, (0.05, 0.05, 0.05))
    zmax = float(pmesh.points[:, 2].max())
    fixes = [{"pos_x": x, "pos_y": y, "pos_z": 0.0, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x, y in [(0, 0), (0, 0.2), (0.2, 0), (0.2, 0.2)]]
    forces = [{"force_x": 0, "force_y": -500.0, "force_z": 0, "force_x_pstn": 0.1,
               "force_y_pstn": 0.1, "force_z_pstn": zmax}]
    fa_n = SolidReactionAnalysis(pmesh, forces, fixes, E=2e11, v=0.3, verbose=False,
                                 cg_tol=1e-8, devices=n, device=dev).run_simulation()
    assert fa_n.solve_info.get("devices") == n, fa_n.solve_info
    assert fa_n.solve_info.get("converged", True), fa_n.solve_info
    eq = float(np.abs(fa_n.equilibrium_residual()).max())
    assert eq < 1e-5, f"structured devices= equilibrium residual: {eq}"
    tick("stage5 public pipeline devices=N (structured, halo distributed-MG)")

    # 6) the public pipeline on an unstructured mesh (relabelled nodes, so
    # no lattice metadata): sharded TG + distributed lattice MG. The instance
    # lowers DENSE_DOF_LIMIT so that the mesh reaches the TG route at every n.
    um0 = box_tet10_from_cells((4, 4, 2 * n), (0.1, 0.1, 0.1))
    relab = np.random.default_rng(11).permutation(um0.num_nodes)
    upts = np.empty_like(um0.points)
    upts[relab] = um0.points
    uconn = relab[np.asarray(um0.cells["tetra10"])]
    umesh = Mesh(points=upts, cells={"tetra10": uconn},
                 cell_physical={"tetra10": np.ones(len(uconn), np.int32)},
                 field_data={"box": (1, 3)})
    uzmax = float(upts[:, 2].max())
    ufixes = [{"pos_x": x, "pos_y": y, "pos_z": 0.0, "fix_x": 0, "fix_y": 0, "fix_z": 0}
              for x, y in [(0, 0), (0, 0.4), (0.4, 0), (0.4, 0.4)]]
    uforces = [{"force_x": 0, "force_y": -500.0, "force_z": 0, "force_x_pstn": 0.2,
                "force_y_pstn": 0.2, "force_z_pstn": uzmax}]
    ua_n = SolidReactionAnalysis(umesh, uforces, ufixes, E=2e11, v=0.3, verbose=False,
                                 cg_tol=1e-8, devices=n, device=dev)
    ua_n.DENSE_DOF_LIMIT = 0
    ua_n.run_simulation()
    assert ua_n.solve_info["method"] == "tg_distributed_lattice_mg_pcg", ua_n.solve_info
    ueq = float(np.abs(ua_n.equilibrium_residual()).max())
    assert ueq < 1e-5, f"unstructured devices= equilibrium residual: {ueq}"
    tick("stage6 public pipeline devices=N (unstructured, lattice-MG)")

    return (f"dryrun_multichip OK: mesh=(batch={nb}, elem={ne}), ndof={ndof}, "
            f"dp_solve+dof_sharded_apply+batched({n_cases} cases) + {structured_note} "
            f"+ PUBLIC pipeline devices={n} (halo distributed-MG, padded "
            f"nz={fa_n.solve_info.get('padded_nz')}, "
            f"{fa_n.solve_info['iterations']} iters, equilibrium {eq:.1e}) "
            f"+ UNSTRUCTURED pipeline devices={n} "
            f"(distributed lattice-MG, {ua_n.solve_info['iterations']} iters, "
            f"equilibrium {ueq:.1e})")


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = "cpu" if "--device" in args and args[args.index("--device") + 1] == "cpu" else "cuda"
    nums = [a for a in args if a.isdigit()]
    fn, ex = entry(dev)
    u, r = fn(*ex)
    print("entry forward_step:", tuple(u.shape), float(u.abs().max()))
    dryrun_multichip(int(nums[0]) if nums else 2, device=dev)
