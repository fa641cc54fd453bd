"""Synthetic data, client partitioning, and federated batching."""
from repro_torch.data.partition import partition_hierarchy
from repro_torch.data.pipeline import FederatedBatcher, SuperBatchPrefetcher
from repro_torch.data.synthetic import clustered_gaussians

__all__ = [
    "FederatedBatcher",
    "SuperBatchPrefetcher",
    "clustered_gaussians",
    "partition_hierarchy",
]
