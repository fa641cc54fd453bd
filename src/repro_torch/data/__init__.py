"""Synthetic data, client partitioning, and federated batching."""
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.data.partition import partition as make_partition, partition_hierarchy, partition_stats
from repro_torch.data.pipeline import (
    CohortPrefetcher,
    FederatedBatcher,
    SuperBatchPrefetcher,
    VirtualClientBatcher,
    global_batch_iterator,
)
from repro_torch.data.synthetic import (
    ClassificationData,
    TokenCorpus,
    clustered_gaussians,
    embedding_corpus,
    token_corpus,
)

__all__ = [
    "partition",
    "pipeline",
    "synthetic",
    "ClassificationData",
    "CohortPrefetcher",
    "FederatedBatcher",
    "SuperBatchPrefetcher",
    "TokenCorpus",
    "VirtualClientBatcher",
    "clustered_gaussians",
    "embedding_corpus",
    "global_batch_iterator",
    "make_partition",
    "partition_hierarchy",
    "partition_stats",
    "token_corpus",
]
