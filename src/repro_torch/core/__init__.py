"""HierFAVG core: hierarchy, aggregation, the training-step functions, costs."""
from repro_torch.core.hierarchy import HierarchySpec, as_hierarchy, parse_fanouts
from repro_torch.core.hierfavg import (
    FedState,
    FedTopology,
    HierFAVGConfig,
    PrecisionSpec,
    build_cohort_super_round,
    build_megakernel_super_round,
    cohort_incompatibility,
    init_cohort_state,
    megakernel_incompatibility,
)

__all__ = [
    "FedState",
    "FedTopology",
    "HierFAVGConfig",
    "HierarchySpec",
    "PrecisionSpec",
    "as_hierarchy",
    "build_cohort_super_round",
    "build_megakernel_super_round",
    "cohort_incompatibility",
    "init_cohort_state",
    "megakernel_incompatibility",
    "parse_fanouts",
]
