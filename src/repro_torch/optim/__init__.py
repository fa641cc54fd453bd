"""Functional optimizers and learning-rate schedules."""
from repro_torch.optim.schedule import constant, cosine_decay, exponential_decay, warmup_cosine
from repro_torch.optim.transforms import (
    GradientTransformation,
    TraceState,
    adam,
    apply_updates,
    chain,
    momentum,
    scale_by_learning_rate,
    sgd,
    trace,
)

__all__ = [
    "GradientTransformation",
    "TraceState",
    "adam",
    "apply_updates",
    "chain",
    "constant",
    "cosine_decay",
    "exponential_decay",
    "momentum",
    "scale_by_learning_rate",
    "sgd",
    "trace",
    "warmup_cosine",
]
