"""Functional optimizers and learning-rate schedules."""
from repro_torch.optim.schedule import constant, exponential_decay
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
    "exponential_decay",
    "momentum",
    "scale_by_learning_rate",
    "sgd",
    "trace",
]
