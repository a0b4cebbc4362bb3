"""Global configuration: precision policy, device selection and
reference-compatibility flags.

Mirrors femx.config (femx/config.py) for the PyTorch port. Two policies are
fixed here, at import:

* TF32 is off for matmuls and cuDNN. Reduced-mantissa products break the
  stiffness operator's symmetry and CG diverges (the JAX package pins
  ``Precision.HIGHEST`` for the same reason).
* The device is explicit and never falls back: ``device=None`` means CUDA,
  and without CUDA an entry point raises unless the caller asked for
  ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DEFAULT_DTYPE = (torch.float64 if os.environ.get("FEMX_DTYPE", "float64") == "float64"
                  else torch.float32)


def default_dtype() -> torch.dtype:
    """The framework-wide default floating dtype (float64 unless FEMX_DTYPE
    says otherwise): the dtype SolidReactionAnalysis solves in when it is
    given none."""
    return _DEFAULT_DTYPE


def set_default_dtype(dtype) -> None:
    """Set the framework-wide default floating dtype (float32 or float64;
    numpy or torch dtype), as femx.config.set_default_dtype does."""
    global _DEFAULT_DTYPE
    _DEFAULT_DTYPE = torch_dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype / type / torch dtype -> torch dtype (float32 or float64)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise TypeError(f"unsupported floating dtype {name!r}")
    return getattr(torch, name)


def numpy_dtype(dtype) -> np.dtype:
    """torch dtype / numpy dtype -> numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises RuntimeError when CUDA is requested (explicitly or by default) and
    absent — the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "femx_torch needs a CUDA device, and torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU explicitly")
    return dev


@dataclasses.dataclass(frozen=True)
class ReferenceCompat:
    """Opt-in switches reproducing documented quirks of the reference app.

    Attributes:
      tet10_quadrature_weight_bug: the reference integrates the Tet10 stiffness
        with Gauss weight w=1/4 per point instead of the correct 1/24
        (ReactionSolver.py:124,146), stiffening K by exactly 6x. Displacements
        scale by 1/6; reactions are unaffected (R = K u). The default is the
        correct w=1/24; set True to bit-match the reference displacement field.
      hardcoded_beam_density: the reference ignores its density input widget and
        uses rho=7850 for the lumped mass matrix (BeamSolver.py:376). The
        default honors the user-provided density; set True to force 7850.
    """

    tet10_quadrature_weight_bug: bool = False
    hardcoded_beam_density: bool = False

    @property
    def tet10_gauss_weight(self) -> float:
        # Correct weight for the 4-point rule on the reference tetrahedron
        # (volume 1/6) is 1/24 per point; the reference uses 1/4.
        return 0.25 if self.tet10_quadrature_weight_bug else 1.0 / 24.0


DEFAULT_COMPAT = ReferenceCompat()
