"""HierFAVG core: hierarchy, aggregation, the training-step functions, costs."""
from repro_torch.core.hierarchy import HierarchySpec, as_hierarchy, parse_fanouts
from repro_torch.core.hierfavg import FedState, FedTopology, HierFAVGConfig

__all__ = [
    "FedState",
    "FedTopology",
    "HierFAVGConfig",
    "HierarchySpec",
    "as_hierarchy",
    "parse_fanouts",
]
