"""The classifier workloads: the MLP the spec builds for
``model.arch="mlp"``, the paper's MNIST and CIFAR-10 CNNs (Section IV-A),
and the classification loss / accuracy.

Port of ``repro.models.cnn`` and of the ``mlp`` bundle
(``repro/fed/api.py:752-773``). Every model keeps the JAX parameter names
and layouts (dense weights ``(in, out)``, convolution weights HWIO
``(kh, kw, in, out)``), so ``models.params_from_numpy`` carries a JAX init
across unchanged.

The CNNs take NHWC images, as JAX's do. ``torch.nn.functional.conv2d``
takes NCHW inputs and OIHW weights, so each apply permutes the images once
(an NHWC tensor seen as NCHW is PyTorch's ``channels_last`` layout) and
each weight at its call, and permutes back to NHWC before the flatten: the
first dense layer's rows are in NHWC order, and flattening NCHW would
scramble them. ``conv2d`` pads VALID (MNIST's 5x5), ``conv2d_same`` SAME
(CIFAR's 3x3: padding 1 on every side, which is what SAME is for an odd
kernel at stride 1), ``maxpool2`` is a 2x2 max of stride 2 with no
padding. The convolutions and pools stay library calls, as JAX's
``lax.conv_general_dilated`` and ``reduce_window`` are no Pallas kernels;
under ``torch.func.vmap`` over client weights a convolution becomes one
grouped convolution.

Parameter counts: the MNIST CNN has the paper's 21,840. The CIFAR CNN
follows the JAX package's layer list (3 blocks of two 3x3 convolutions,
32/64/128 channels, then 2048 -> 2048 -> 512 -> 10): 5,537,578
parameters, where the paper quotes 5,852,170 without printing its layers.

Losses take ``(params, batch, rng)`` like the JAX losses; the paper losses
ignore ``rng`` (``repro/models/cnn.py:124-125``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.tree import leaves

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


# -- the paper's CNNs ------------------------------------------------------------


def _conv_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, padding) -> torch.Tensor:
    """An NCHW image batch convolved with an HWIO weight at stride 1, plus
    the bias (added after the convolution, as JAX adds it)."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), padding=padding) + b[:, None, None]


def _pool_nchw(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=2, stride=2)


def _nhwc_rows(x: torch.Tensor) -> torch.Tensor:
    """An NCHW batch flattened in NHWC order: the dense layers' row order."""
    return x.permute(0, 2, 3, 1).flatten(1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C), w: (kh, kw, C, O) -> (B, H-kh+1, W-kw+1, O): VALID."""
    return _conv_nchw(x.permute(0, 3, 1, 2), w, b, 0).permute(0, 2, 3, 1)


def conv2d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """As ``conv2d`` with SAME padding (odd kernels: (k - 1) / 2 a side)."""
    if w.shape[0] % 2 == 0 or w.shape[1] % 2 == 0:
        raise ValueError(f"conv2d_same takes odd kernels, got {tuple(w.shape[:2])}")
    return _conv_nchw(x.permute(0, 3, 1, 2), w, b, (w.shape[0] // 2, w.shape[1] // 2)).permute(0, 2, 3, 1)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H // 2, W // 2, C): 2x2 windows, stride 2, VALID."""
    return _pool_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# (layer name, weight shape) in the JAX init's draw order: 4-d shapes are
# HWIO convolutions, 2-d ones dense layers; each layer's bias is zero
MNIST_LAYERS: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("c1", (5, 5, 1, 10)), ("c2", (5, 5, 10, 20)), ("f1", (320, 50)), ("f2", (50, 10)),
)
CIFAR_LAYERS: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("c1a", (3, 3, 3, 32)), ("c1b", (3, 3, 32, 32)), ("c2a", (3, 3, 32, 64)), ("c2b", (3, 3, 64, 64)),
    ("c3a", (3, 3, 64, 128)), ("c3b", (3, 3, 128, 128)),
    ("f1", (2048, 2048)), ("f2", (2048, 512)), ("f3", (512, 10)),
)


class _CNN(nn.Module):
    """Parameters ``<layer>w`` / ``<layer>b`` as the JAX init names them;
    weights ``N(0, 1) * sqrt(2 / fan_in)`` (fan_in = kh * kw * in for a
    convolution, in for a dense layer), biases zero. The draws come from a
    torch generator, so they differ from the JAX init: carry that across
    with ``models.params_from_numpy``."""

    layers: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()
    apply_fn: Callable = None

    def __init__(self, *, device=None, generator: torch.Generator = None):
        super().__init__()
        for name, shape in self.layers:
            fan_in = shape[0] * shape[1] * shape[2] if len(shape) == 4 else shape[0]
            w = torch.randn(*shape, generator=generator, device=device) * (2.0 / fan_in) ** 0.5
            self.register_parameter(name + "w", nn.Parameter(w))
            self.register_parameter(name + "b", nn.Parameter(torch.zeros(shape[-1], device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return type(self).apply_fn(dict(self.named_parameters()), x)


def mnist_cnn_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 28, 28, 1) -> logits (B, 10)."""
    p = params
    h = x.permute(0, 3, 1, 2)
    h = torch.relu(_pool_nchw(_conv_nchw(h, p["c1w"], p["c1b"], 0)))  # 24 -> 12
    h = torch.relu(_pool_nchw(_conv_nchw(h, p["c2w"], p["c2b"], 0)))  # 8 -> 4
    h = torch.relu(_nhwc_rows(h) @ p["f1w"] + p["f1b"])  # 4 * 4 * 20 = 320
    return h @ p["f2w"] + p["f2b"]


def cifar_cnn_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 32, 32, 3) -> logits (B, 10)."""
    p = params
    h = x.permute(0, 3, 1, 2)
    for block in ("c1", "c2", "c3"):  # 32 -> 16 -> 8 -> 4
        h = torch.relu(_conv_nchw(h, p[block + "aw"], p[block + "ab"], 1))
        h = _pool_nchw(torch.relu(_conv_nchw(h, p[block + "bw"], p[block + "bb"], 1)))
    h = torch.relu(_nhwc_rows(h) @ p["f1w"] + p["f1b"])  # 128 * 4 * 4 = 2048
    h = torch.relu(h @ p["f2w"] + p["f2b"])
    return h @ p["f3w"] + p["f3b"]


class MnistCNN(_CNN):
    """The paper's MNIST CNN: 21,840 parameters."""

    layers = MNIST_LAYERS
    apply_fn = staticmethod(mnist_cnn_apply)


class CifarCNN(_CNN):
    """The CIFAR-10 CNN of the JAX package's layer list: 5,537,578 parameters."""

    layers = CIFAR_LAYERS
    apply_fn = staticmethod(cifar_cnn_apply)


def _init(cls, rng: torch.Generator, device) -> Params:
    module = cls(device=device if device is not None else rng.device, generator=rng)
    return {k: v.detach() for k, v in module.named_parameters()}


def init_mnist_cnn(rng: torch.Generator, device=None) -> Params:
    """Unstacked MNIST CNN parameters drawn from ``rng`` (on its device
    unless ``device`` is given)."""
    return _init(MnistCNN, rng, device)


def init_cifar_cnn(rng: torch.Generator, device=None) -> Params:
    """Unstacked CIFAR CNN parameters drawn from ``rng``."""
    return _init(CifarCNN, rng, device)


def count_params(tree: Any) -> int:
    return sum(x.numel() for x in leaves(tree))
