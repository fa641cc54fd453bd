"""Functional optimizers and learning-rate schedules."""
from repro_torch.optim.schedule import constant, cosine_decay, exponential_decay, warmup_cosine
from repro_torch.optim import compression
from repro_torch.optim.transforms import (
    GradientTransformation,
    TraceState,
    adam,
    add_decayed_weights,
    apply_updates,
    chain,
    clip_by_global_norm,
    identity,
    momentum,
    scale,
    scale_by_adam,
    scale_by_learning_rate,
    sgd,
    trace,
)

__all__ = [
    "GradientTransformation",
    "TraceState",
    "adam",
    "add_decayed_weights",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "compression",
    "constant",
    "cosine_decay",
    "exponential_decay",
    "identity",
    "momentum",
    "scale",
    "scale_by_adam",
    "scale_by_learning_rate",
    "sgd",
    "trace",
    "warmup_cosine",
]
