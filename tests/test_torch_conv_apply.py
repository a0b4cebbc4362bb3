"""femx_torch.assembly_conv (the conv-form structured apply) against femx's
assembly_conv and against the port's own slot apply, and the conv routing
of StructuredSolidOperator and SolidReactionAnalysis against femx's.

Tolerances: float64 1e-12 and float32 1e-5 of the result's max (the two
forms sum the same products in another order); the analyses' reactions
1e-9 relative to the load, iteration counts equal.

femx routes by FEMX_STRUCTURED_APPLY, which its analysis writes into
os.environ and which it reads at trace time: every femx case here sets it
through monkeypatch (so the teardown restores it) and clears jax's caches
on the way out, so femx tests that share the worker keep the slot form.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femx
import femx_torch
from femx.assembly_conv import apply_conv as fx_apply_conv
from femx.assembly_conv import build_kernels as fx_build_kernels
from femx.assembly_structured import StructuredSolidOperator as FxOp
from femx_torch.assembly_conv import apply_conv, build_kernels, conv_kernels
from femx_torch.assembly_structured import StructuredSolidOperator as PtOp
from femx_torch.assembly_structured import conv_routing_active

torch.set_num_threads(2)

SPACING = (0.1, 0.13, 0.08)
TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture
def femx_conv_env(monkeypatch):
    """FEMX_STRUCTURED_APPLY=conv for femx, restored and jax's caches
    cleared afterwards."""
    monkeypatch.setenv("FEMX_STRUCTURED_APPLY", "conv")
    monkeypatch.setenv("FEMX_CONV_MIN_CELLS", "0")
    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    jax.clear_caches()
    yield monkeypatch
    jax.clear_caches()


def _ops(n_cells, dtype, **kw):
    fx = FxOp.from_lattice(n_cells, SPACING, 2e11, 0.3, dtype=dtype)
    pt = PtOp.from_lattice(n_cells, SPACING, 2e11, 0.3, dtype=dtype, device="cpu", **kw)
    return fx, pt


def test_build_kernels_equal_femx_exactly():
    fx, pt = _ops((2, 2, 2), np.float64)
    ref = fx_build_kernels(fx.Kcell)
    got = build_kernels(pt.Kcell)
    assert set(got) == set(ref) and len(got) == 27
    for mode3, W in ref.items():
        assert got[mode3].dtype == torch.float64
        np.testing.assert_array_equal(got[mode3].numpy(), np.asarray(W), err_msg=str(mode3))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_cells", [(3, 4, 5), (2, 2, 2), (1, 1, 1)])
def test_apply_conv_matches_femx_and_slot(n_cells, dtype):
    """Every correction mode: (1, 1, 1) and (2, 2, 2) put all 26 phantom
    corrections on the same few nodes, (3, 4, 5) mixes odd and even."""
    fx, pt = _ops(n_cells, dtype)
    u = np.random.default_rng(11).standard_normal(pt.ndof).astype(dtype)
    ref = np.asarray(fx_apply_conv(fx, jnp.asarray(u)))
    got = apply_conv(pt, torch.as_tensor(u))
    assert got.dtype == torch.as_tensor(u).dtype
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= TOL[dtype] * scale
    slot = pt.apply(torch.as_tensor(u)).numpy()  # slot form: apply_form "slot"
    assert np.abs(got.numpy() - slot).max() <= TOL[dtype] * scale


def test_kernels_cached_per_operator_dtype_and_device():
    _, pt = _ops((2, 3, 2), np.float64, apply_form="conv")
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(pt.ndof))
    apply_conv(pt, u)
    first = pt._conv_kernels[(torch.float64, torch.device("cpu"))]
    apply_conv(pt, u)
    assert pt._conv_kernels[(torch.float64, torch.device("cpu"))] is first
    assert len(pt._conv_kernels) == 1
    # a masked copy shares the cell matrix, so it keeps the kernels
    masked = pt.with_free_mask(np.ones(pt.ndof))
    assert masked._conv_kernels is pt._conv_kernels
    full, corr = conv_kernels(pt, torch.float32, torch.device("cpu"))
    assert full.dtype == torch.float32 and len(corr) == 26 and len(pt._conv_kernels) == 2


@pytest.mark.parametrize("n_cells,gate,weighted,expect", [
    ((2, 3, 2), "0", False, True),
    ((2, 3, 2), "12", False, True),     # exactly at the gate: conv
    ((2, 3, 2), "13", False, False),    # below the gate: slot
    ((2, 2, 4), "0", True, False),      # layer weights: slot
])
def test_routing_gates_match_femx(femx_conv_env, n_cells, gate, weighted, expect):
    """The cell-count gate FEMX_CONV_MIN_CELLS and the layer-weight gate
    decide as femx's conv_routing_active does, and the routed apply
    (apply_constrained too) equals femx's routed apply."""
    from femx.assembly_structured import conv_routing_active as fx_active

    femx_conv_env.setenv("FEMX_CONV_MIN_CELLS", gate)
    jax.clear_caches()
    fx, pt = _ops(n_cells, np.float64, apply_form="conv")
    if weighted:
        zw = np.ones(n_cells[2])
        zw[-1] = 0.0
        fx_w = dataclasses.replace(fx, z_weight=jnp.asarray(zw))
        object.__setattr__(fx_w, "_Kcell_host", fx.Kcell_host)
        fx = fx_w
        pt = dataclasses.replace(pt, z_weight=torch.as_tensor(zw))
    assert fx_active(fx) is expect
    assert conv_routing_active(pt) is expect
    mask = np.ones(pt.ndof)
    mask[:pt.ndof // 7] = 0.0
    u = np.random.default_rng(4).standard_normal(pt.ndof)
    ref = np.asarray(fx.with_free_mask(mask).apply_constrained(jnp.asarray(u)))
    got = pt.with_free_mask(mask).apply_constrained(torch.as_tensor(u)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    # slot form whatever the gate says
    slot = dataclasses.replace(pt, apply_form="slot")
    assert not conv_routing_active(slot)


def test_form_reaches_every_level_and_env_default(monkeypatch):
    """The operator's form passes to the multigrid levels built from it (each
    gated by its size); FEMX_STRUCTURED_APPLY is the default of an operator
    built without one, and a bad form raises."""
    from femx_torch.solve.multigrid import StructuredMultigrid

    monkeypatch.setenv("FEMX_CONV_MIN_CELLS", "0")
    monkeypatch.delenv("FEMX_STRUCTURED_APPLY", raising=False)
    n = (4, 4, 8)
    op = PtOp.from_lattice(n, SPACING, 2e11, 0.3, dtype=np.float64, device="cpu",
                           apply_form="conv")
    mask = np.ones((9, 9, 17, 3))
    mask[:, :, 0] = 0.0  # clamp the z = 0 face
    mask = mask.reshape(-1)
    mg = StructuredMultigrid(None, n, 2e11, 0.3, mask, spacing=SPACING, dtype=np.float64,
                             fine_op=op.with_free_mask(op.to_internal(mask)), coarse_dof_limit=300,
                             device="cpu")
    assert len(mg.levels) >= 2
    assert all(lvl.op.apply_form == "conv" for lvl in mg.levels)
    assert PtOp.from_lattice(n, SPACING, 2e11, 0.3, device="cpu").apply_form == "slot"
    monkeypatch.setenv("FEMX_STRUCTURED_APPLY", "conv")
    assert PtOp.from_lattice(n, SPACING, 2e11, 0.3, device="cpu").apply_form == "conv"
    with pytest.raises(ValueError, match="structured_apply"):
        PtOp.from_lattice(n, SPACING, 2e11, 0.3, device="cpu", apply_form="bogus")


def _point_supported(pkg, dims=(0.4, 0.4, 1.2), h=0.1, **kw):
    mesh = pkg.box_tet10(*dims, mesh_size=h, force_points=[(0.2, 0.4, 0.6)],
                         fix_points=[(0, 0, 0), (0.4, 0, 0), (0, 0, 1.2), (0.4, 0, 1.2)])
    forces = [{"force_x": 0, "force_y": 500.0, "force_z": 0,
               "force_x_pstn": 0.2, "force_y_pstn": 0.4, "force_z_pstn": 0.6}]
    fixes = [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x, z in [(0, 0), (0.4, 0), (0, 1.2), (0.4, 1.2)]]
    return pkg.SolidReactionAnalysis(mesh, forces, fixes, E=2e11, v=0.3, verbose=False,
                                     **kw).run_simulation()


def _reactions(fa):
    return np.array([fa.reaction_forces[3 * i["node_idx"]:3 * i["node_idx"] + 3]
                     for i in fa.fixed_nodes_info])


@pytest.mark.parametrize("solver", ["mg", "cg"])
def test_analysis_conv_matches_femx(femx_conv_env, solver):
    """SolidReactionAnalysis(structured_apply="conv") with the gate lowered:
    femx's iteration count and reactions (to 1e-9 of the load), the same
    solve_info["structured_apply"], and the port's slot analysis to the same
    tolerance. Under MG every level routes conv (the gate is 0)."""
    fx = _point_supported(femx, solver=solver, structured_apply="conv")
    pt = _point_supported(femx_torch, solver=solver, structured_apply="conv", device="cpu")
    assert fx.solve_info["structured_apply"] == pt.solve_info["structured_apply"] == "conv"
    assert pt.solve_info["method"] == fx.solve_info["method"]
    assert pt.solve_info["iterations"] == fx.solve_info["iterations"]
    np.testing.assert_allclose(_reactions(pt), _reactions(fx), rtol=0, atol=1e-9 * 500.0)
    slot = _point_supported(femx_torch, solver=solver, structured_apply="slot", device="cpu")
    assert slot.solve_info["structured_apply"] == "slot"
    assert abs(slot.solve_info["iterations"] - pt.solve_info["iterations"]) <= 1
    np.testing.assert_allclose(_reactions(pt), _reactions(slot), rtol=0, atol=1e-9 * 500.0)


def test_analysis_records_the_form_that_ran(monkeypatch):
    """Below the cell gate the requested conv form is recorded as slot (the
    form that ran), as femx records it; the environment picks the form when
    the argument is None, and the analysis changes no environment."""
    monkeypatch.delenv("FEMX_CONV_MIN_CELLS", raising=False)
    monkeypatch.delenv("FEMX_STRUCTURED_APPLY", raising=False)
    pt = _point_supported(femx_torch, solver="cg", structured_apply="conv", device="cpu")
    assert pt.structured_apply == "conv" and pt.solve_info["structured_apply"] == "slot"
    import os

    assert "FEMX_STRUCTURED_APPLY" not in os.environ
    monkeypatch.setenv("FEMX_STRUCTURED_APPLY", "conv")
    mesh = femx_torch.box_tet10(0.2, 0.1, 0.1, 0.05)
    fa = femx_torch.SolidReactionAnalysis(mesh, [], [], E=2e11, v=0.3, verbose=False,
                                          device="cpu")
    assert fa.structured_apply == "conv"
    with pytest.raises(ValueError, match="structured_apply"):
        femx_torch.SolidReactionAnalysis(mesh, [], [], E=2e11, v=0.3, verbose=False,
                                         device="cpu", structured_apply="bogus")
