"""femx_torch.ui: GUI layer, headless view-models + optional PyQt5 bindings
(port of femx/ui)."""

from femx_torch.ui.models import (
    IMPLEMENTED_PRODUCTS,
    PRODUCT_OPTIONS,
    SECTION_TYPES,
    BeamAnalysisModel,
    ReactionCalculatorModel,
)

__all__ = [
    "IMPLEMENTED_PRODUCTS",
    "PRODUCT_OPTIONS",
    "SECTION_TYPES",
    "BeamAnalysisModel",
    "ReactionCalculatorModel",
]
