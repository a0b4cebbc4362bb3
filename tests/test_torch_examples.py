"""The port's counterparts of femx's Pallas repros (examples/) == femx's
repros on the same inputs. femx's kernels run in Pallas interpret mode: the
test hands each repro module a `pl` whose pallas_call is interpreted, so
examples/ stays as it is. B3 (repro_dynslice_value) and B12 (the kernel
local to bench_dyngather.main) are held against the jnp expression of their
kernel bodies and bench_dyngather.py's own check."""

import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from femx_torch.examples import bench_dyngather, gather_repros, mosaic_repros
from femx_torch.gather import take_along_axis

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _interpreted(name):
    """femx's examples/<name>.py with its pallas_call run in interpret mode."""
    spec = importlib.util.spec_from_file_location(f"_femx_examples_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                   BlockSpec=pl.BlockSpec)
    return mod


@pytest.fixture(scope="module")
def femx_mosaic():
    return _interpreted("pallas_mosaic_repros")


@pytest.fixture(scope="module")
def femx_gather():
    return _interpreted("pallas_gather_repros")


@pytest.mark.parametrize("name", ["repro_reshape_merge", "repro_strip_loop",
                                  "repro_strip_loop_f32_carry",
                                  "repro_strip_loop_pyint_bounds"])
def test_mosaic_repros_match_femx(femx_mosaic, name):
    want = np.asarray(getattr(femx_mosaic, name)())
    got = getattr(mosaic_repros, name)(device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_dynslice_repro_matches_its_kernel_body():
    """B3: the kernel body is lax.dynamic_slice(x, (i, 0), (8, 128)), i = 4."""
    x = jnp.arange(16 * 128, dtype=jnp.float32).reshape(16, 128)
    want = np.asarray(lax.dynamic_slice(x, (4, 0), (8, 128)))
    np.testing.assert_array_equal(mosaic_repros.repro_dynslice_value(device="cpu").numpy(), want)


@pytest.mark.parametrize("name", ["repro_take_values", "repro_take_rows_2d",
                                  "repro_take_along_lanes", "repro_take_along_sublanes",
                                  "repro_dynamic_ref_rows"])
def test_gather_repros_match_femx(femx_gather, name):
    want = np.asarray(getattr(femx_gather, name)())
    got = getattr(gather_repros, name)(device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_examples_runner_and_expected():
    for mod in (mosaic_repros, gather_repros):
        for name in mod.REPROS:
            np.testing.assert_array_equal(mod.REPROS[name](device="cpu").numpy(),
                                          mod.expected(name))
    assert mosaic_repros.run("x", lambda: torch.zeros(3))
    assert not mosaic_repros.run("y", lambda: 1 / 0)


def test_dyngather_matches_its_kernel_body_and_check(capsys):
    """B12: the kernel body's lax.gather (femx's dimension numbers) on one
    grid step, and the sweep's own check at small sizes."""
    dnums = lax.GatherDimensionNumbers(offset_dims=(), collapsed_slice_dims=(0,),
                                       start_index_map=(0,), operand_batching_dims=(1,),
                                       start_indices_batching_dims=(1,))
    for H in (8, 32):
        rng = np.random.default_rng(0)
        tab = rng.standard_normal((H, 128)).astype(np.float32)
        idx = rng.integers(0, H, size=(H, 128)).astype(np.int32)
        want = np.asarray(lax.gather(jnp.asarray(tab), jnp.asarray(idx)[..., None], dnums,
                                     (1, 1), mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS))
        got = torch.gather(torch.from_numpy(tab), 0, torch.from_numpy(idx).long()).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            take_along_axis(torch.from_numpy(tab), torch.from_numpy(idx).long(), 0).numpy(),
            want)
    rows = bench_dyngather.main(device="cpu", heights=(8, 32, 128), total=2048, reps=1)
    assert [r["H"] for r in rows] == [8, 32, 128]
    assert all(r["correct"] and r["device"] == "cpu" and "host_ms" in r for r in rows)
    assert [r["grid"] for r in rows] == [256, 64, 16]
    assert capsys.readouterr().out.count('"correct": true') == 3
