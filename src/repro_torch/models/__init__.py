"""Models on the main path."""
from repro_torch.models.cnn import (
    MLP,
    accuracy,
    classification_loss,
    make_cnn_loss_fn,
    mlp_bundle,
    params_from_numpy,
)

__all__ = [
    "MLP",
    "accuracy",
    "classification_loss",
    "make_cnn_loss_fn",
    "mlp_bundle",
    "params_from_numpy",
]
