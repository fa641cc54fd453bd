"""Synthetic data, client partitioning, and federated batching."""
from repro_torch.data.partition import partition as make_partition, partition_hierarchy
from repro_torch.data.pipeline import FederatedBatcher, SuperBatchPrefetcher
from repro_torch.data.synthetic import TokenCorpus, clustered_gaussians, embedding_corpus, token_corpus

__all__ = [
    "FederatedBatcher",
    "SuperBatchPrefetcher",
    "TokenCorpus",
    "clustered_gaussians",
    "embedding_corpus",
    "make_partition",
    "partition_hierarchy",
    "token_corpus",
]
