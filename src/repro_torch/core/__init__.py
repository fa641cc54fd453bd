"""HierFAVG core: hierarchy, aggregation, the training-step functions, costs."""
from repro_torch.core.hierarchy import HierarchySpec, as_hierarchy, parse_fanouts
from repro_torch.core.hierfavg import (
    FedState,
    FedTopology,
    HierFAVGConfig,
    PrecisionSpec,
    build_megakernel_super_round,
    megakernel_incompatibility,
)

__all__ = [
    "FedState",
    "FedTopology",
    "HierFAVGConfig",
    "HierarchySpec",
    "PrecisionSpec",
    "as_hierarchy",
    "build_megakernel_super_round",
    "megakernel_incompatibility",
    "parse_fanouts",
]
