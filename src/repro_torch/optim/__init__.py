"""Functional optimizers and learning-rate schedules."""
from repro_torch.optim.schedule import constant, exponential_decay
from repro_torch.optim.transforms import (
    GradientTransformation,
    adam,
    apply_updates,
    chain,
    scale_by_learning_rate,
    sgd,
)

__all__ = [
    "GradientTransformation",
    "adam",
    "apply_updates",
    "chain",
    "constant",
    "exponential_decay",
    "scale_by_learning_rate",
    "sgd",
]
