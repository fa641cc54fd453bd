"""Synthetic datasets with controllable non-IIDness.

Copy-port of ``repro.data.synthetic`` (numpy): ``clustered_gaussians``
(the classifier data), ``token_corpus`` (a Markov-teacher LM corpus with
one sparse transition kernel per class, so label-skewed partitions give
divergent client gradients) and ``embedding_corpus`` (the stub-frontend
archs' inputs). The same generator draws in the same order, so a seeded
call returns arrays byte-identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClassificationData:
    x: np.ndarray  # (n, ...) float32
    y: np.ndarray  # (n,) int32


def clustered_gaussians(
    rng: np.random.Generator,
    *,
    num_samples: int = 10_000,
    num_classes: int = 10,
    dim: Tuple[int, ...] = (28, 28, 1),
    class_sep: float = 3.0,
    noise: float = 1.0,
) -> ClassificationData:
    """C well-separated Gaussian clusters in a flattened image space;
    ``class_sep``/``noise`` tune difficulty."""
    d = int(np.prod(dim))
    centers = rng.normal(0.0, class_sep, size=(num_classes, d))
    y = rng.integers(0, num_classes, size=num_samples).astype(np.int32)
    x = centers[y] + rng.normal(0.0, noise, size=(num_samples, d))
    return ClassificationData(x=x.reshape((num_samples, *dim)).astype(np.float32), y=y)


@dataclasses.dataclass(frozen=True)
class TokenCorpus:
    tokens: np.ndarray  # (n, seq_len+1) int32: inputs[t], targets shifted by one
    labels: np.ndarray  # (n,) int32 "topic" class of each sequence

    @property
    def num_samples(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1


def token_corpus(
    rng: np.random.Generator,
    *,
    num_sequences: int = 2048,
    seq_len: int = 128,
    vocab: int = 256,
    num_classes: int = 10,
    concentration: float = 0.3,
) -> TokenCorpus:
    """Markov-teacher corpus: each class has its own Dirichlet transition
    kernel; a lower ``concentration`` makes the kernels sparser and the
    per-class gradients more divergent. The kernels are one f64 table of
    (num_classes, vocab, vocab): 16.8 MB at 8 classes and vocab 512."""
    kernels = rng.dirichlet(np.full(vocab, concentration), size=(num_classes, vocab))
    labels = rng.integers(0, num_classes, size=num_sequences).astype(np.int32)
    toks = np.empty((num_sequences, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=num_sequences)
    for t in range(seq_len):
        p = kernels[labels, toks[:, t]]  # (n, vocab)
        cdf = np.cumsum(p, axis=1)
        u = rng.random((num_sequences, 1))
        toks[:, t + 1] = (u < cdf).argmax(axis=1)
    return TokenCorpus(tokens=toks, labels=labels)


def embedding_corpus(
    rng: np.random.Generator,
    *,
    num_sequences: int = 512,
    seq_len: int = 64,
    d_model: int = 64,
    num_classes: int = 10,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stub-frontend corpus for the [vlm]/[audio] archs: precomputed
    frame/patch embeddings (f32) and integer targets. Returns
    (embeds, targets, labels)."""
    centers = rng.normal(0, 1, size=(num_classes, d_model))
    labels = rng.integers(0, num_classes, size=num_sequences).astype(np.int32)
    embeds = centers[labels][:, None, :] + 0.3 * rng.normal(0, 1, size=(num_sequences, seq_len, d_model))
    targets = rng.integers(0, num_classes * 8, size=(num_sequences, seq_len)).astype(np.int32)
    return embeds.astype(np.float32), targets, labels
