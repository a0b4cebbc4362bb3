"""Analyses: the solid reaction solve, beam frames, shaft modal, 2D plane
and axisymmetric pipe thermal stress."""

from femx_torch.analysis.beam import BeamAnalysis, BeamResults
from femx_torch.analysis.pipe import PipeThermalAnalysis
from femx_torch.analysis.plane import PlaneAnalysis
from femx_torch.analysis.shaft import ShaftModalAnalysis, ShaftMode
from femx_torch.analysis.solid import ForceAnalysis, SolidReactionAnalysis

__all__ = [
    "BeamAnalysis",
    "BeamResults",
    "ForceAnalysis",
    "PipeThermalAnalysis",
    "PlaneAnalysis",
    "ShaftModalAnalysis",
    "ShaftMode",
    "SolidReactionAnalysis",
]
