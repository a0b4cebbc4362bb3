"""femx_torch command-line interface (port of femx/cli.py): the headless
front end to every product, on the CUDA card.

  python -m femx_torch mesh-box --dims 0.8 0.2 0.8 --mesh-size 0.05 \
      --force 0,3000,0@0.4,0.2,0.4 --fix 0.0,0.0,0.0:xyz -o mesh.msh
  python -m femx_torch solid --msh mesh.msh --E 2e11 --nu 0.3 \
      --force 0,3000,0@0.4,0.2,0.4 --fix 0,0,0:xyz --report out.md
  python -m femx_torch beam --msh frame.msh --E 2e11 --nu 0.3 --rho 7850 \
      --section 'beam=I section:d=0.05,b=0.025,t_w=0.005,t_f=0.005,r=0.001' \
      --fix-group fix:xyzXYZ --force-group load_y=0,-3000,0 --report out.md
  python -m femx_torch section --type 'I section' --params d=0.05,b=0.025,...
  python -m femx_torch shaft --segment 2.0,0.04 --bearing 0 --bearing 2 \
      --E 2e11 --nu 0.3 --json
  python -m femx_torch plane --plate 1.0 0.2 --mesh-size 0.025 --E 2e11 \
      --nu 0.3 --thickness 0.01 --force-edge right=0,-1000 --fix-edge left
  python -m femx_torch pipe --ri 0.05 --ro 0.08 --E 2e11 --nu 0.3 \
      --Ti 200 --To 50 --pi 5e6 --json

--platform auto (the default) and gpu run every subcommand on the CUDA card
and raise without one; cpu runs on the CPU. (femx sends every subcommand
but solid to the CPU under auto; the port's entry points run on the card
unless asked for the CPU.)
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List


def _parse_vec3(s: str) -> List[float]:
    return [float(v) for v in s.split(",")]


def _parse_force_at(s: str):
    vec, pos = s.split("@")
    f = _parse_vec3(vec)
    p = _parse_vec3(pos)
    return {
        "force_x": f[0], "force_y": f[1], "force_z": f[2],
        "force_x_pstn": p[0], "force_y_pstn": p[1], "force_z_pstn": p[2],
    }


def _parse_fix_at(s: str):
    pos, axes = s.split(":") if ":" in s else (s, "xyz")
    p = _parse_vec3(pos)
    axes = axes.lower()
    return {
        "pos_x": p[0], "pos_y": p[1], "pos_z": p[2],
        "fix_x": 0 if "x" in axes else None,
        "fix_y": 0 if "y" in axes else None,
        "fix_z": 0 if "z" in axes else None,
    }


def _parse_params(s: str) -> dict:
    out = {}
    for kv in s.split(","):
        k, v = kv.split("=")
        out[k.strip()] = float(v)
    return out


def _parse_section(s: str) -> dict:
    head, params = s.split(":", 1)
    group, stype = head.split("=", 1)
    p = _parse_params(params)
    rotate = bool(p.pop("rotate", 0))
    return {"group": group, "type": stype, "params": p, "rotate": rotate}


def _parse_fix_group(s: str) -> dict:
    group, axes = s.split(":")
    low = axes
    return {
        "group": group, "type": "Fix",
        "fix_x": "x" in low, "fix_y": "y" in low, "fix_z": "z" in low,
        "fix_rx": "X" in axes, "fix_ry": "Y" in axes, "fix_rz": "Z" in axes,
    }


def _parse_force_group(s: str) -> dict:
    group, vec = s.split("=")
    f = _parse_vec3(vec)
    return {"group": group, "type": "Force", "force_x": f[0], "force_y": f[1], "force_z": f[2]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="femx_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--platform", choices=["auto", "cpu", "gpu"], default="auto",
                    help="device: auto and gpu run on the CUDA card (raising "
                         "without one), cpu on the CPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    mb = sub.add_parser("mesh-box", help="generate a structured Tetra10 box mesh")
    mb.add_argument("--dims", nargs=3, type=float, required=True, metavar=("X", "Y", "Z"))
    mb.add_argument("--mesh-size", type=float, required=True)
    mb.add_argument("--force", action="append", default=[], help="fx,fy,fz@x,y,z")
    mb.add_argument("--fix", action="append", default=[], help="x,y,z[:axes]")
    mb.add_argument("-o", "--output", default="generated_mesh.msh")
    mb.add_argument("--html", default=None, metavar="PATH",
                    help="also export a standalone interactive mesh-preview "
                         "viewer (wireframe + physical groups + BC markers; "
                         "the reference's pre-solve gmsh FLTK popup)")

    so = sub.add_parser("solid", help="3D solid reaction-force analysis")
    so.add_argument("--msh", help=".msh input (omit with --box to generate)")
    so.add_argument("--box", nargs=3, type=float, metavar=("X", "Y", "Z"))
    so.add_argument("--mesh-size", type=float, default=0.05)
    so.add_argument("--E", type=float, required=True)
    so.add_argument("--nu", type=float, required=True)
    so.add_argument("--force", action="append", default=[], required=False)
    so.add_argument("--fix", action="append", default=[], required=False)
    so.add_argument("--solver", choices=["auto", "dense", "cg", "mg"], default="auto")
    so.add_argument("--compat-quadrature-bug", action="store_true",
                    help="reproduce the reference's w=1/4 Tet10 weight")
    so.add_argument("--report", default=None)
    so.add_argument("--plot", default=None, help="save result view PNG")
    so.add_argument("--stress", action="store_true",
                    help="recover nodal stresses; prints the von Mises max "
                         "and adds a stress section to --report")
    so.add_argument("--plot-color", choices=["disp", "von_mises"],
                    default="disp", help="--plot coloring field")
    so.add_argument("--html", default=None,
                    help="export standalone interactive WebGL viewer")
    so.add_argument("--devices", type=int, default=None, metavar="N",
                    help="multi-device solves: N ranks, one process each "
                         "(z-slab halo MG-PCG on a box, sharded TG with the "
                         "distributed lattice MG on a .msh); rank 0 prints "
                         "and writes the outputs")
    so.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="resumable solve: persist CG state to PATH.npz "
                         "between iteration chunks and resume from it on "
                         "re-run (crash/preemption recovery)")
    so.add_argument("--unstructured-op",
                    choices=["tg", "cluster", "groupell"],
                    default=None,
                    help="operator family for large unstructured meshes: "
                         "transpose-gather (default), Morton-clustered "
                         "dense blocks (fewer gather rows, heavier build) "
                         "or group-ELL pre-assembled pair/group blocks "
                         "(fastest apply; pre-assembled block storage "
                         "grows with mesh size)")
    so.add_argument("--structured-apply", choices=["slot", "conv"],
                    default=None,
                    help="structured-lattice apply form: the slot stack with "
                         "the cell-matmul kernel (default) or the conv-form "
                         "stencil (femx_torch.assembly_conv, one 3x3x3 "
                         "24-channel correlation)")
    so.add_argument("--checkpoint-chunk", type=int, default=500,
                    help="iterations per checkpoint segment (default 500)")
    so.add_argument("--modal", type=int, default=0, metavar="N",
                    help="also compute the first N natural frequencies "
                         "(shift-invert Lanczos, HRZ-lumped mass)")
    so.add_argument("--rho", type=float, default=7850.0,
                    help="density for --modal [kg/m^3]")

    be = sub.add_parser("beam", help="3D Timoshenko frame analysis")
    be.add_argument("--msh", required=True)
    be.add_argument("--E", type=float, required=True)
    be.add_argument("--nu", type=float, required=True)
    be.add_argument("--rho", type=float, default=7850.0)
    be.add_argument("--mass", choices=["lumped", "consistent"], default="lumped")
    be.add_argument("--section", action="append", default=[],
                    help="group=TYPE:k=v,... (e.g. beam=I section:d=0.05,b=0.025,t_w=0.005,t_f=0.005)")
    be.add_argument("--fix-group", action="append", default=[], help="group:xyzXYZ")
    be.add_argument("--force-group", action="append", default=[], help="group=fx,fy,fz")
    be.add_argument("--distributed-group", action="append", default=[],
                    help="line-group=wx,wy,wz (N/m, global axes)")
    be.add_argument("--section-method", choices=["auto", "fem", "closed_form"], default="auto")
    be.add_argument("--report", default=None)
    be.add_argument("--json", action="store_true", help="print results as JSON")

    se = sub.add_parser("section", help="compute section properties")
    se.add_argument("--type", required=True)
    se.add_argument("--params", required=True)
    se.add_argument("--rotate", action="store_true")
    se.add_argument("--method", choices=["auto", "fem", "closed_form"], default="auto")

    sh = sub.add_parser("shaft", help="shaft modal / critical-speed analysis")
    sh.add_argument("--segment", action="append", required=True,
                    metavar="L,D[,D_INNER]",
                    help="axial step: length,outer_dia[,inner_dia] (repeat "
                         "in order from x=0)")
    sh.add_argument("--bearing", action="append", type=float, required=True,
                    metavar="X", help="pinned bearing position (repeat)")
    sh.add_argument("--E", type=float, required=True)
    sh.add_argument("--nu", type=float, required=True)
    sh.add_argument("--rho", type=float, default=7850.0)
    sh.add_argument("--modes", type=int, default=12)
    sh.add_argument("--elem-length", type=float, default=None)
    sh.add_argument("--free-torsion", action="store_true",
                    help="leave the torsional branch free-free (spinning "
                         "shaft) instead of locking r_x at the thrust bearing")
    sh.add_argument("--report", default=None, help="write .md/.docx report")
    sh.add_argument("--plot-mode", type=int, default=0, metavar="K",
                    help="save mode-shape PNG for mode K")
    sh.add_argument("--plot", default="shaft_mode.png",
                    help="PNG path for --plot-mode")
    sh.add_argument("--json", action="store_true")

    pl = sub.add_parser("plane", help="2D plane stress/strain static analysis")
    pl.add_argument("--msh", help="Tri6 (or Tri3) .msh input")
    pl.add_argument("--plate", nargs=2, type=float, metavar=("W", "H"),
                    help="generate a structured Tri6 rectangle instead")
    pl.add_argument("--mesh-size", type=float, default=0.025)
    pl.add_argument("--E", type=float, required=True)
    pl.add_argument("--nu", type=float, required=True)
    pl.add_argument("--thickness", type=float, default=1.0)
    pl.add_argument("--mode", choices=["stress", "strain"], default="stress")
    pl.add_argument("--force-edge", action="append", default=[],
                    metavar="GROUP=FX,FY",
                    help="total force resultant over an edge group "
                         "(left/right/bottom/top for --plate meshes)")
    pl.add_argument("--fix-edge", action="append", default=[],
                    metavar="GROUP[:AXES]", help="fix an edge group (xy)")
    pl.add_argument("--force", action="append", default=[],
                    metavar="FX,FY@X,Y", help="point force")
    pl.add_argument("--fix", action="append", default=[],
                    metavar="X,Y[:AXES]", help="point fix")
    pl.add_argument("--alpha", type=float, default=0.0,
                    help="thermal expansion coefficient [1/K]")
    pl.add_argument("--dT", type=float, default=None,
                    help="uniform temperature rise [K] (thermoelastic load; "
                         "needs --alpha)")
    pl.add_argument("--modal", type=int, default=0, metavar="N",
                    help="also compute the first N 2D natural frequencies "
                         "(consistent Tri6 mass)")
    pl.add_argument("--rho", type=float, default=7850.0,
                    help="density for --modal [kg/m^3]")
    pl.add_argument("--report", default=None, help="write .md/.docx report")
    pl.add_argument("--plot", default=None, help="save deformed contour PNG")
    pl.add_argument("--plot-field",
                    choices=["von_mises", "disp", "sxx", "syy", "sxy"],
                    default="von_mises")
    pl.add_argument("--json", action="store_true")

    pi = sub.add_parser("pipe", help="pipe thermal + pressure stress "
                                     "(axisymmetric)")
    pi.add_argument("--ri", type=float, required=True, help="inner radius [m]")
    pi.add_argument("--ro", type=float, required=True, help="outer radius [m]")
    pi.add_argument("--length", type=float, default=0.3)
    pi.add_argument("--E", type=float, required=True)
    pi.add_argument("--nu", type=float, required=True)
    pi.add_argument("--alpha", type=float, default=1.2e-5)
    pi.add_argument("--Ti", type=float, default=0.0,
                    help="inner-wall temperature rise [K]")
    pi.add_argument("--To", type=float, default=0.0,
                    help="outer-wall temperature rise [K]")
    pi.add_argument("--pi", type=float, default=0.0, dest="p_inner",
                    help="internal pressure [Pa]")
    pi.add_argument("--po", type=float, default=0.0, dest="p_outer",
                    help="external pressure [Pa]")
    pi.add_argument("--rho", type=float, default=0.0,
                    help="density [kg/m^3] (needed for --rpm)")
    pi.add_argument("--rpm", type=float, default=0.0,
                    help="spin speed [RPM] -> centrifugal body load")
    pi.add_argument("--end", choices=["plane_strain", "free"],
                    default="plane_strain")
    pi.add_argument("--nr", type=int, default=24)
    pi.add_argument("--nz", type=int, default=12)
    pi.add_argument("--report", default=None, help="write .md/.docx report")
    pi.add_argument("--plot", default=None,
                    help="save wall-contour + radial-profile PNG")
    pi.add_argument("--json", action="store_true")

    return ap


# deadline (s) of a --devices N run: past it every rank is killed
DEVICES_TIMEOUT = 3600.0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    # the device every analysis of this run gets: the card unless --platform cpu
    from femx_torch.config import resolve_device

    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")

    if args.cmd == "solid" and (args.devices or 0) > 1:
        from femx_torch.parallel import launch

        return launch(_solid_rank, args.devices, argv, device=device.type,
                      timeout=DEVICES_TIMEOUT)

    if args.cmd == "mesh-box":
        from femx_torch.mesh import box_tet10, write_msh

        mesh = box_tet10(
            *args.dims, mesh_size=args.mesh_size,
            force_points=[_parse_vec3(f.split("@")[1]) for f in args.force],
            fix_points=[_parse_vec3(f.split(":")[0]) for f in args.fix],
        )
        write_msh(args.output, mesh)
        print(f"Wrote {args.output}: {mesh.num_nodes} nodes, "
              f"{len(mesh.cells['tetra10'])} tetra10 elements")
        if args.html:
            from femx_torch.viz_html import export_mesh_html

            print(f"Mesh preview: {export_mesh_html(mesh, args.html)}")
        return 0

    if args.cmd == "solid":
        return _run_solid(args, device)

    if args.cmd == "beam":
        from femx_torch.analysis import BeamAnalysis
        from femx_torch.mesh import read_msh

        mesh = read_msh(args.msh)
        section_data = [_parse_section(s) for s in args.section]
        bc_data = [_parse_fix_group(s) for s in args.fix_group] + [
            _parse_force_group(s) for s in args.force_group
        ]
        for s in args.distributed_group:
            group, vec = s.split("=")
            wx, wy, wz = _parse_vec3(vec)
            bc_data.append({"group": group, "type": "DistributedForce",
                            "wx": wx, "wy": wy, "wz": wz})
        ba = BeamAnalysis(mesh, section_data, bc_data, E=args.E, nu=args.nu,
                          rho=args.rho, mass=args.mass, section_method=args.section_method,
                          device=device)
        res = ba.run()
        import numpy as np

        if args.json:
            print(json.dumps({
                "max_displacement": float(np.abs(res.u.reshape(-1, 6)[:, :3]).max()),
                "max_stress_mpa": float(res.smoothed_stresses.max() / 1e6),
                "frequencies_hz": [float(f) for f in res.natural_frequencies_hz[:10]],
            }))
        else:
            disp = res.u.reshape(-1, 6)[:, :3]
            mags = np.linalg.norm(disp, axis=1)
            imax = int(np.argmax(mags))
            print(f"Max displacement: {mags[imax]:.4e} m at node {imax}")
            smax = int(np.argmax(res.smoothed_stresses))
            print(f"Max stress: {res.smoothed_stresses[smax] / 1e6:.4f} MPa at node {smax}")
            print("Natural frequencies (Hz):",
                  ", ".join(f"{f:.4f}" for f in res.natural_frequencies_hz[:10]))
        if args.report:
            from femx_torch.report import beam_report

            out = beam_report(ba, res, args.report)
            print(f"Report written to {out}")
        return 0

    if args.cmd == "shaft":
        from femx_torch.analysis import ShaftModalAnalysis

        segments = []
        for s in args.segment:
            vals = _parse_vec3(s)
            seg = {"length": vals[0], "d": vals[1]}
            if len(vals) > 2 and vals[2] > 0:
                seg["d_inner"] = vals[2]
            segments.append(seg)
        sm = ShaftModalAnalysis(
            segments, args.bearing, E=args.E, nu=args.nu, rho=args.rho,
            target_elem_length=args.elem_length,
            free_torsion=args.free_torsion, verbose=not args.json, device=device)
        modes = sm.run(n_modes=args.modes)
        if args.json:
            print(json.dumps({
                "modes": [{"frequency_hz": m.frequency_hz,
                           "family": m.family,
                           "critical_speed_rpm": m.critical_speed_rpm}
                          for m in modes],
                "critical_speeds_rpm": list(sm.critical_speeds_rpm),
            }))
        if args.report:
            print(f"Report written to {sm.generate_report(args.report)}")
        if args.plot_mode:
            print(f"Saved mode {args.plot_mode} shape to "
                  f"{sm.plot_mode(args.plot_mode, args.plot)}")
        return 0

    if args.cmd == "plane":
        import numpy as np

        from femx_torch.analysis import PlaneAnalysis
        from femx_torch.mesh import read_msh
        from femx_torch.mesh.generators2d import rect_tri6

        forces = [{"group": g, "force_x": f[0], "force_y": f[1]}
                  for g, f in ((s.split("=")[0], _parse_vec3(s.split("=")[1]))
                               for s in args.force_edge)]
        for s in args.force:
            vec, pos = s.split("@")
            f, p = _parse_vec3(vec), _parse_vec3(pos)
            forces.append({"force_x": f[0], "force_y": f[1],
                           "force_x_pstn": p[0], "force_y_pstn": p[1]})
        fixes = []
        for s in args.fix_edge:
            group, axes = s.split(":") if ":" in s else (s, "xy")
            fixes.append({"group": group,
                          "fix_x": 0 if "x" in axes else None,
                          "fix_y": 0 if "y" in axes else None})
        for s in args.fix:
            pos, axes = s.split(":") if ":" in s else (s, "xy")
            p = _parse_vec3(pos)
            fixes.append({"pos_x": p[0], "pos_y": p[1],
                          "fix_x": 0 if "x" in axes else None,
                          "fix_y": 0 if "y" in axes else None})
        if args.msh:
            mesh = read_msh(args.msh)
        elif args.plate:
            mesh = rect_tri6(*args.plate, args.mesh_size)
        else:
            print("error: provide --msh or --plate", file=sys.stderr)
            return 2
        pa = PlaneAnalysis(mesh, forces, fixes, E=args.E, v=args.nu,
                           thickness=args.thickness, mode=args.mode,
                           alpha=args.alpha, temperature=args.dT,
                           verbose=not args.json, device=device)
        pa.run_simulation()
        _, vm = pa.compute_stresses()
        imax = int(np.argmax(vm))
        modal_hz = None
        if args.modal:
            res = pa.modal(n_modes=args.modal, rho=args.rho)
            modal_hz = [float(w) / (2 * np.pi) for w in res.omega.cpu().numpy()]
            if not args.json:
                print("Natural frequencies [Hz]: "
                      + ", ".join(f"{f:.4f}" for f in modal_hz))
        if args.json:
            payload = {
                "max_displacement": float(
                    np.abs(pa.u.reshape(-1, 2)).max()),
                "max_von_mises_mpa": float(vm[imax] / 1e6),
                "equilibrium_residual": [float(v)
                                         for v in pa.equilibrium_residual()],
                "solve_info": pa.solve_info,
            }
            if modal_hz is not None:
                payload["frequencies_hz"] = modal_hz
            print(json.dumps(payload))
        else:
            x, y = (float(v) for v in pa.points[imax, :2])
            print(f"Max von Mises stress: {vm[imax] / 1e6:.4f} MPa at node "
                  f"{imax} ({x:g}, {y:g})")
        if args.report:
            print(f"Report written to {pa.generate_report(args.report)}")
        if args.plot:
            pa.plot(args.plot, field=args.plot_field)
            print(f"Saved result view to {args.plot}")
        return 0

    if args.cmd == "pipe":
        import numpy as np

        from femx_torch.analysis import PipeThermalAnalysis

        pa = PipeThermalAnalysis(
            args.ri, args.ro, length=args.length, E=args.E, v=args.nu,
            alpha=args.alpha, T_inner=args.Ti, T_outer=args.To,
            pressure_inner=args.p_inner, pressure_outer=args.p_outer,
            rho=args.rho, spin_rpm=args.rpm,
            end_condition=args.end, n_r=args.nr, n_z=args.nz,
            verbose=not args.json, device=device)
        pa.run_simulation()
        if args.json:
            radii, s_tt = pa.radial_profile(pa.stress_nodes[:, 2])
            print(json.dumps({
                "max_von_mises_mpa": float(pa.von_mises.max() / 1e6),
                "max_radial_displacement": float(
                    np.abs(pa.u[0::2]).max()),
                "bore_hoop_stress_mpa": float(s_tt[0] / 1e6),
                "radii": [float(r) for r in radii],
                "hoop_profile_mpa": [float(v / 1e6) for v in s_tt],
                "solve_info": pa.solve_info,
            }))
        if args.report:
            print(f"Report written to {pa.generate_report(args.report)}")
        if args.plot:
            pa.plot(args.plot)
            print(f"Saved result view to {args.plot}")
        return 0

    if args.cmd == "section":
        from femx_torch.sections import compute_properties

        p = compute_properties(args.type, _parse_params(args.params),
                               rotate=args.rotate, method=args.method, device=device)
        print(json.dumps({
            "A": p.A, "I_x": p.I_x, "I_y": p.I_y, "J": p.J,
            "kappa_y": p.kappa_y, "kappa_z": p.kappa_z,
            "c_y_max": p.c_y_max, "c_z_max": p.c_z_max,
        }))
        return 0

    return 2


def _solid_rank(argv) -> int:
    """One rank of `solid --devices N`: the same analysis on every rank;
    rank 0 prints and writes the report and viewer outputs."""
    from femx_torch.parallel import comm

    args = build_parser().parse_args(argv)
    return _run_solid(args, comm.rank_device(comm.rank(), "cpu" if args.platform == "cpu"
                                             else "cuda"), lead=comm.rank() == 0)


def _run_solid(args, device, lead: bool = True) -> int:
    """The solid subcommand; with lead False (ranks other than 0 of a
    --devices run) it prints nothing and writes no file."""
    from femx_torch.analysis import SolidReactionAnalysis
    from femx_torch.config import ReferenceCompat
    from femx_torch.mesh import box_tet10, read_msh

    forces = [_parse_force_at(f) for f in args.force]
    fixes = [_parse_fix_at(f) for f in args.fix]
    if args.msh:
        mesh = read_msh(args.msh)
    elif args.box:
        mesh = box_tet10(
            *args.box, mesh_size=args.mesh_size,
            force_points=[[f["force_x_pstn"], f["force_y_pstn"], f["force_z_pstn"]] for f in forces],
            fix_points=[[f["pos_x"], f["pos_y"], f["pos_z"]] for f in fixes],
        )
    else:
        if lead:
            print("error: provide --msh or --box", file=sys.stderr)
        return 2
    compat = ReferenceCompat(tet10_quadrature_weight_bug=args.compat_quadrature_bug)
    fa = SolidReactionAnalysis(mesh, forces, fixes, E=args.E, v=args.nu,
                               compat=compat, solver=args.solver,
                               devices=args.devices,
                               checkpoint=args.checkpoint,
                               checkpoint_chunk=args.checkpoint_chunk,
                               unstructured_operator=args.unstructured_op,
                               structured_apply=args.structured_apply,
                               verbose=lead, device=device)
    fa.run_simulation(report=False)
    say = print if lead else (lambda *a, **k: None)
    if args.stress:
        import numpy as np

        _, vm = fa.compute_stresses()
        imax = int(np.argmax(vm))
        x, y, z = (float(v) for v in fa.points[imax])
        say(f"Max von Mises stress: {vm[imax] / 1e6:.4f} MPa at node "
              f"{imax} ({x:g}, {y:g}, {z:g})")
    if args.modal:
        import numpy as np

        res = fa.modal(n_modes=args.modal, rho=args.rho)
        hz = res.omega.cpu().numpy() / (2 * np.pi)
        say("Natural frequencies [Hz]: "
              + ", ".join(f"{f:.4f}" for f in hz))
    if not lead:  # the modal solve above runs on every rank; outputs on rank 0
        return 0
    if args.report:  # after stress/modal so the report includes them
        fa.generate_report(args.report)
    if args.plot:
        fa.plot(show_window=False, filename=args.plot,
                color="von_mises" if args.plot_color == "von_mises"
                else "disp")
        print(f"Saved result view to {args.plot}")
    if args.html:
        out = fa.export_html(args.html)
        print(f"Saved interactive viewer to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
