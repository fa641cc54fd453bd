"""Synthetic data, client partitioning, and federated batching."""
from repro_torch.data.partition import partition as make_partition, partition_hierarchy
from repro_torch.data.pipeline import (
    CohortPrefetcher,
    FederatedBatcher,
    SuperBatchPrefetcher,
    VirtualClientBatcher,
)
from repro_torch.data.synthetic import TokenCorpus, clustered_gaussians, embedding_corpus, token_corpus

__all__ = [
    "CohortPrefetcher",
    "FederatedBatcher",
    "SuperBatchPrefetcher",
    "TokenCorpus",
    "VirtualClientBatcher",
    "clustered_gaussians",
    "embedding_corpus",
    "make_partition",
    "partition_hierarchy",
    "token_corpus",
]
