"""Parametric cross-section geometry and properties (port of femx.sections)."""

from femx_torch.sections.geometry import SectionGeometry, build_geometry
from femx_torch.sections.properties import (
    SectionProperties,
    calculate_section_properties,
    compute_properties,
    polygon_moments,
    torsion_rectangle,
)

__all__ = [
    "SectionGeometry",
    "build_geometry",
    "SectionProperties",
    "calculate_section_properties",
    "compute_properties",
    "polygon_moments",
    "torsion_rectangle",
]
