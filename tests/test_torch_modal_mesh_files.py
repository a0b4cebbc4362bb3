"""femx_torch.SolidReactionAnalysis.modal on the transpose-gather routes of a
.msh file (block-Jacobi and lattice MG) == femx's own TG routes on the
same file, on the CPU (torch_modal_cases.py holds the cases and checks)."""

import pytest
import torch

from torch_modal_cases import check_analysis_modal, check_f32_refined_modal, write_files

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_femx_disk_cache(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_files(tmp_path_factory)


@pytest.mark.parametrize("branch", ["tg_block_jacobi_pcg", "tg_lattice_mg_pcg"])
def test_analysis_modal_matches_femx(branch, files):
    """f64 omega without and with refine at rtol 1e-6 of femx's refined
    ones (torch_modal_cases.check_analysis_modal)."""
    check_analysis_modal(branch, files)


@pytest.mark.parametrize("branch", ["tg_block_jacobi_pcg"])
def test_f32_refined_modal_reaches_femx_f64(branch, files):
    """float32 refine=True within 1e-6 of femx's float64 refined omega."""
    check_f32_refined_modal(branch, files)
