"""Communication-compression operators over parameter trees.

Port of ``repro.optim.compression``. Trees are (nested) dicts of tensors;
leaves are visited in sorted-key order, as ``jax.tree_util`` orders dict
leaves, so a ``QuantizedTree``'s metadata lines up with the JAX package's.
int8 quantization runs K4 / K5 (``kernels.quantize``) on CUDA tensors and
their plain versions on CPU tensors, in the flat layout: each leaf
flattened, zero-padded to a ``block`` multiple, one f32 scale per block.
``randk_sparsify`` draws from a ``torch.Generator``; it does not reproduce
the JAX package's random bits.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops

Tree = Any


def _leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _rebuild(tree: Tree, leaves) -> Tree:
    """``tree``'s structure with the next values of the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


class QuantizedTree(NamedTuple):
    """Per-leaf int8 payload (num_blocks, block) and f32 scales
    (num_blocks,). ``shapes`` / ``dtypes`` record the original leaves in
    leaf order, so ``dequantize_int8`` needs no ``like`` tree."""

    payload: Tree
    scales: Tree
    block: int
    shapes: Optional[Tuple[Tuple[int, ...], ...]] = None
    dtypes: Optional[Tuple[torch.dtype, ...]] = None


def quantize_int8(tree: Tree, block: int = 256) -> QuantizedTree:
    leaves = _leaves(tree)
    qs = [ops.quantize_int8(x, block)[:2] for x in leaves]
    return QuantizedTree(
        payload=_rebuild(tree, iter([q for q, _ in qs])),
        scales=_rebuild(tree, iter([s[:, 0] for _, s in qs])),
        block=block,
        shapes=tuple(tuple(x.shape) for x in leaves),
        dtypes=tuple(x.dtype for x in leaves),
    )


def dequantize_int8(q: QuantizedTree, like: Optional[Tree] = None) -> Tree:
    """Inverse of ``quantize_int8``. ``like`` overrides the recorded shapes
    and dtypes, and is required for a tree built without them."""
    ps, ss = _leaves(q.payload), _leaves(q.scales)
    if like is not None:
        shapes = [tuple(x.shape) for x in _leaves(like)]
        dtypes = [x.dtype for x in _leaves(like)]
    elif q.shapes is not None and q.dtypes is not None:
        shapes, dtypes = list(q.shapes), list(q.dtypes)
    else:
        raise ValueError("QuantizedTree has no shape/dtype metadata; pass the `like` tree")
    if not len(ps) == len(ss) == len(shapes) == len(dtypes):
        raise ValueError(
            f"inconsistent QuantizedTree: {len(ps)} payload leaves, "
            f"{len(ss)} scale leaves, {len(shapes)} shapes, {len(dtypes)} dtypes"
        )
    out = [ops.dequantize_int8(p, s[:, None], shape, dtype) for p, s, shape, dtype in zip(ps, ss, shapes, dtypes)]
    return _rebuild(q.payload, iter(out))


def compressed_bytes(q: QuantizedTree) -> int:
    """Wire size of the compressed tree: 1 byte a code, 4 a scale."""
    return sum(x.numel() for x in _leaves(q.payload)) + 4 * sum(x.numel() for x in _leaves(q.scales))


def topk_sparsify(tree: Tree, frac: float) -> Tuple[Tree, Tree]:
    """Keep the largest-magnitude ``frac`` of each leaf (ties at the
    threshold kept), zero the rest. Returns (sparse tree, mask tree)."""

    def leaf(x):
        flat = x.reshape(-1)
        k = max(int(flat.numel() * frac), 1)
        thresh = torch.sort(torch.abs(flat)).values[-k]
        mask = (torch.abs(x) >= thresh).to(x.dtype)
        return x * mask, mask

    out = [leaf(x) for x in _leaves(tree)]
    return _rebuild(tree, iter([s for s, _ in out])), _rebuild(tree, iter([m for _, m in out]))


def randk_sparsify(tree: Tree, frac: float, generator: torch.Generator) -> Tuple[Tree, Tree]:
    """Unbiased random-k sparsification: keep each value with probability
    ``frac`` and scale it by 1/frac. Returns (sparse tree, mask tree)."""
    masks = [
        (torch.rand(x.shape, generator=generator, device=x.device) < frac).to(x.dtype) for x in _leaves(tree)
    ]
    sparse = [x * m / frac for x, m in zip(_leaves(tree), masks)]
    return _rebuild(tree, iter(sparse)), _rebuild(tree, iter(masks))
