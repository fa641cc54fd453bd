"""The classifier workloads on the main path: the MLP the spec builds for
``model.arch="mlp"`` and the classification loss / accuracy.

Port of the parts of ``repro.models.cnn`` and of the ``mlp`` bundle
(``repro/fed/api.py:752-773``) that the main path runs. The MLP keeps the
JAX parameter names and layout (``w1 (dim, hidden)``, ``b1``,
``w2 (hidden, classes)``, ``b2``), so ``models.params_from_numpy`` carries a
JAX init across unchanged. The MNIST/CIFAR CNNs are not reachable from
``ExperimentSpec`` and wait for a later slice.

Losses take ``(params, batch, rng)`` like the JAX losses; the paper losses
ignore ``rng`` (``repro/models/cnn.py:124-125``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch import nn
from torch.func import functional_call

Params = Dict[str, torch.Tensor]


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.mean(lse - tgt)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels.long()).to(torch.float32))


def make_cnn_loss_fn(apply_fn: Callable[[Params, torch.Tensor], torch.Tensor]):
    """HierFAVG-compatible loss: batch = {"inputs": x, "targets": labels}."""

    def loss_fn(params, batch, rng):
        return classification_loss(apply_fn(params, batch["inputs"]), batch["targets"])

    return loss_fn


class MLP(nn.Module):
    """``relu(x @ w1 + b1) @ w2 + b2`` with the JAX package's parameter
    names and layout; init ``N(0, 1) * 0.25`` weights and zero biases, as
    ``repro/fed/api.py:760-767`` (from a torch generator, so the numbers
    differ from the JAX init: carry that across with ``models.params_from_numpy``)."""

    def __init__(self, dim: int, hidden: int, classes: int, *, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        normal = lambda *shape: torch.randn(*shape, generator=generator, device=device) * 0.25
        self.w1 = nn.Parameter(normal(dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(hidden, device=device))
        self.w2 = nn.Parameter(normal(hidden, classes))
        self.b2 = nn.Parameter(torch.zeros(classes, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


def mlp_bundle(dim: int, hidden: int, classes: int, device: torch.device) -> Dict[str, Any]:
    """{"module", "init", "apply", "loss"} for the benchmark MLP. ``init``
    takes a seed and returns unstacked parameters; ``apply``/``loss`` are
    functional over a parameter dict (``torch.func.functional_call``), so
    the local step can ``vmap`` them over stacked client parameters."""
    module = MLP(dim, hidden, classes, device="meta")

    def init(seed: int) -> Params:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        fresh = MLP(dim, hidden, classes, device=device, generator=gen)
        return {k: v.detach() for k, v in fresh.named_parameters()}

    def apply_fn(params: Params, x: torch.Tensor) -> torch.Tensor:
        return functional_call(module, params, (x,))

    return {"module": module, "init": init, "apply": apply_fn, "loss": make_cnn_loss_fn(apply_fn)}
