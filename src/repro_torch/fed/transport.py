"""Per-level compressed transport: link codecs for HierFAVG.

Port of ``repro.fed.transport``. A codec models what one uplink does to a
client's model delta (w - w_anchor); a ``TransportSpec`` assigns one codec
per tree level, bottom-up, and plugs into ``HierFAVGConfig`` beside the
kappa vector. ``core.hierfavg.build_level_sync`` routes every aggregation
boundary through the level's codec.

Codecs are simulated transport: ``roundtrip`` applies encode then decode,
so the aggregator sees exactly what a receiver would reconstruct, and the
wire size is accounted analytically through ``bits_per_param``
(``dist.collectives``, ``core.cost_model``).

Quantization blocks never cross client boundaries: every stacked leaf
(N, ...) is flattened to (N, D) and quantized row by row in blocks of
``block`` along D. On a CUDA tensor that round trip is K4 then K5
(``kernels.quantize``), one launch each per leaf; on a CPU tensor their
plain versions. Error feedback (``int8_ef``): the residual e = (delta + r)
- decode(encode(delta + r)) is carried per client in ``FedState.residual``
and added to the next upload.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.tree import Tree, tree_map


# ---------------------------------------------------------------------------
# Row-wise blockwise int8 quantization (K4 / K5)
# ---------------------------------------------------------------------------


def quantize_rows(x2d: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) -> (q (N, Dp) int8, scales (N, Dp / block) f32), Dp = D padded
    to a block multiple per row (K4 on CUDA)."""
    return ops.quantize_stacked(x2d, block)


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor, d: int, block: int) -> torch.Tensor:
    """Inverse of ``quantize_rows``: (N, Dp) int8 + (N, Dp / block) scales ->
    (N, d) f32 (K5 on CUDA)."""
    if q.shape[1] != scales.shape[1] * block:
        raise ValueError(f"q {tuple(q.shape)} and scales {tuple(scales.shape)} do not hold blocks of {block}")
    return ops.dequantize_stacked(q, scales, d)


def _roundtrip_leaf(x: torch.Tensor, block: int) -> torch.Tensor:
    """encode then decode one stacked (N, ...) leaf; f32, same shape."""
    n = x.shape[0]
    flat = x.to(torch.float32).reshape(n, -1)
    q, s = quantize_rows(flat, block)
    return dequantize_rows(q, s, flat.shape[1], block).reshape(x.shape)


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IdentityCodec:
    """Uncompressed fp32 link: the paper's transport."""

    name: str = "identity"
    error_feedback: bool = False

    @property
    def is_identity(self) -> bool:
        return True

    @property
    def bits_per_param(self) -> float:
        return 32.0

    def roundtrip(self, tree: Tree, residual: Optional[Tree]):
        return tree, residual


@dataclasses.dataclass(frozen=True)
class Int8BlockCodec:
    """Blockwise-absmax int8: 8 bits a value plus one f32 scale per
    ``block`` values, 8 + 32/block bits per parameter."""

    block: int = 256
    error_feedback: bool = False

    def __post_init__(self):
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")

    @property
    def name(self) -> str:
        suffix = "_ef" if self.error_feedback else ""
        return f"int8{suffix}:{self.block}"

    @property
    def is_identity(self) -> bool:
        return False

    @property
    def bits_per_param(self) -> float:
        return 8.0 + 32.0 / self.block

    def roundtrip(self, tree: Tree, residual: Optional[Tree]):
        """tree: f32 deltas with stacked (N, ...) leaves. Returns (decoded
        deltas, new residual). Without error feedback the residual passes
        through untouched; with it, the deltas absorb the carried residual
        and the new residual is the fresh rounding error."""
        if self.error_feedback:
            if residual is None:
                raise ValueError("error-feedback codec needs a residual tree in FedState")
            e = tree_map(lambda d, r: d.to(torch.float32) + r.to(torch.float32), tree, residual)
            decoded = tree_map(lambda x: _roundtrip_leaf(x, self.block), e)
            return decoded, tree_map(torch.sub, e, decoded)
        return tree_map(lambda x: _roundtrip_leaf(x, self.block), tree), residual


def int8_ef(block: int = 256) -> Int8BlockCodec:
    """int8 with an error-feedback residual (EF-SGD on the link)."""
    return Int8BlockCodec(block=block, error_feedback=True)


_CODEC_FACTORIES = {
    "identity": lambda block: IdentityCodec(),
    "fp32": lambda block: IdentityCodec(),
    "int8": lambda block: Int8BlockCodec(block=block),
    "int8_ef": lambda block: int8_ef(block),
}


def parse_codec(text: str):
    """'identity' | 'int8' | 'int8_ef' with an optional ':block' suffix,
    e.g. 'int8:128'."""
    name, _, block = text.strip().partition(":")
    if name not in _CODEC_FACTORIES:
        raise ValueError(f"unknown codec {name!r}; choose from {sorted(_CODEC_FACTORIES)}")
    return _CODEC_FACTORIES[name](int(block) if block else 256)


# ---------------------------------------------------------------------------
# Per-level spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """One codec per aggregation level, bottom-up: ``codecs[0]`` is the
    client->edge uplink (level 1), ``codecs[-1]`` the top (cloud) hop."""

    codecs: Tuple[Any, ...]

    def __post_init__(self):
        object.__setattr__(self, "codecs", tuple(self.codecs))
        if not self.codecs:
            raise ValueError("TransportSpec needs at least one level")

    @classmethod
    def identity(cls, depth: int) -> "TransportSpec":
        return cls(codecs=tuple(IdentityCodec() for _ in range(depth)))

    @classmethod
    def uniform(cls, codec, depth: int) -> "TransportSpec":
        return cls(codecs=tuple(codec for _ in range(depth)))

    @classmethod
    def cloud_int8(cls, depth: int, *, block: int = 256, error_feedback: bool = False) -> "TransportSpec":
        """fp32 on the lower hops, int8 on the top hop."""
        top = Int8BlockCodec(block=block, error_feedback=error_feedback)
        return cls(codecs=tuple(IdentityCodec() for _ in range(depth - 1)) + (top,))

    @classmethod
    def parse(cls, text: str) -> "TransportSpec":
        """'/'-separated codec per level, bottom-up: 'identity/int8' is an
        fp32 edge hop and an int8 cloud hop."""
        parts = [p for p in text.split("/") if p]
        if not parts:
            raise ValueError(f"empty transport spec: {text!r}")
        return cls(codecs=tuple(parse_codec(p) for p in parts))

    @property
    def depth(self) -> int:
        return len(self.codecs)

    def codec(self, level: int):
        if not 1 <= level <= self.depth:
            raise ValueError(f"level must be in 1..{self.depth}, got {level}")
        return self.codecs[level - 1]

    @property
    def is_trivial(self) -> bool:
        """True iff every level is identity: the uncompressed protocol."""
        return all(c.is_identity for c in self.codecs)

    @property
    def needs_residual(self) -> bool:
        return any(c.error_feedback for c in self.codecs)

    def bits_per_param(self, level: int) -> float:
        return float(self.codec(level).bits_per_param)

    def bits_vector(self) -> Tuple[float, ...]:
        """Per-level bits per parameter, bottom-up, as
        ``dist.collectives.hierarchy_traffic_per_step`` takes them."""
        return tuple(float(c.bits_per_param) for c in self.codecs)

    def describe(self) -> str:
        return "/".join(c.name for c in self.codecs)


# ---------------------------------------------------------------------------
# Fused decode + aggregate (K6)
# ---------------------------------------------------------------------------


def fused_decode_segment_mean(
    q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, segment_ids, num_segments: int
) -> torch.Tensor:
    """The per-segment weighted mean of the decoded rows of int8 payloads,
    q (N, D) + scales (N, D / qblock) -> (N, D) f32, without materialising
    the f32 decode (K6 on CUDA). Equals ``dequantize_rows`` followed by
    ``core.aggregation.segment_weighted_mean`` up to the order of the f32
    sums."""
    return ops.segment_dequant_mean(q, scales, weights, segment_ids, num_segments)


def transport_wire_bytes_per_param(spec: Optional[TransportSpec], depth: int) -> Tuple[float, ...]:
    """Per-level wire bytes per fp32 parameter (spec=None: uncompressed)."""
    if spec is None:
        return tuple(4.0 for _ in range(depth))
    return tuple(b / 8.0 for b in spec.bits_vector())
