"""Synthetic classification data with controllable non-IIDness.

Copy-port of ``repro.data.synthetic.clustered_gaussians`` (numpy): the
same generator draws in the same order, so a seeded call returns arrays
byte-identical to the JAX package's. ``token_corpus`` (the LM corpus)
comes with the LM slice.
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
