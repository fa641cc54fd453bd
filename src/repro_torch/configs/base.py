"""Config schema: architecture, federated topology, sharding and shapes.

A data copy of the JAX package's ``configs/base.py``: one ``ArchConfig`` per
assigned architecture lives in ``repro_torch/configs/<id>.py`` with the exact
dimensions from the assignment, plus a ``smoke()`` reduction of the same
family for CPU tests. The only change: ``ArchConfig.dtype()`` returns a torch
dtype, parsed by numpy's name rules as ``jnp.dtype`` parses it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: (seq_len, global_batch, kind)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class FedPlan:
    """How HierFAVG maps onto the mesh for this architecture.

    layout "stacked": params get a leading client axis N = edges*clients_per_edge,
      sharded P(("pod","data")); TP within client over "model".
    layout "sharded": one client per pod (cross-silo); leading axis = num_pods,
      inner dims sharded over ("data","model") (FSDP x TP/EP).

    ``fanouts``/``kappas`` opt into ragged / deeper-than-two trees
    (see ``core.hierarchy``): fanouts is the bottom-up child-count nest of
    ``HierarchySpec.from_fanouts`` and describes the FULL tree across all
    pods (unlike the uniform path, which scales edges_per_pod by the
    mesh's pod count); kappas the matching per-level schedule. When None,
    the uniform two-level (edges_per_pod, clients_per_edge, kappa1,
    kappa2) plan applies unchanged.
    """

    layout: str = "stacked"  # "stacked" | "sharded"
    edges_per_pod: int = 4
    clients_per_edge: int = 4
    kappa1: int = 16
    kappa2: int = 4
    fanouts: Optional[Tuple[Tuple[int, ...], ...]] = None  # ragged tree (None -> uniform)
    kappas: Optional[Tuple[int, ...]] = None  # per-level schedule (None -> (κ₁, κ₂))

    def hierarchy(self, num_pods: int = 1):
        """The aggregation tree this plan describes (lazy import: configs
        stay importable without the core package initialized). ``num_pods``
        scales the uniform path only — explicit ``fanouts`` are the full
        tree already."""
        from repro_torch.core.hierarchy import HierarchySpec

        if self.fanouts is not None:
            return HierarchySpec.from_fanouts([list(l) for l in self.fanouts])
        return HierarchySpec.uniform(num_pods * self.edges_per_pod, self.clients_per_edge)

    def schedule(self):
        from repro_torch.core.hierfavg import HierFAVGConfig

        if self.kappas is not None:
            return HierFAVGConfig.multi_level(self.kappas)
        return HierFAVGConfig(kappa1=self.kappa1, kappa2=self.kappa2)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # block pattern, cycled over layers, e.g. ("rglru","rglru","local_attn")
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0  # local-attention window (0 = full causal)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # stub frontends ([vlm]/[audio]): inputs are precomputed embeddings
    embed_inputs: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    d_rnn: int = 0  # rglru width (0 -> d_model)
    mlstm_chunk: int = 256
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # training-step knobs (overridable per cell by the dry-run/perf loop)
    grad_accum: int = 1
    # per-client microbatch (sequences per grad-accum step); the launcher
    # derives grad_accum = per_client_batch // microbatch for each mesh
    microbatch: int = 1
    remat: str = "full"  # "none" | "full" | "dots"
    scan_layers: bool = True
    # flash-style q/k chunking for full-sequence attention: chunk when
    # S > attn_chunk (bounds activation memory to O(S·chunk) per layer);
    # 0 disables. The Pallas kernel replaces this on real TPU.
    attn_chunk: int = 1024
    # which assigned shapes apply; long_500k only for sub-quadratic archs
    run_long_context: bool = False
    fed: FedPlan = dataclasses.field(default_factory=FedPlan)
    # citation tag from the assignment
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_rnn_resolved(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_superblocks(self) -> int:
        return self.num_layers // self.pattern_period

    @property
    def tail_layers(self) -> int:
        return self.num_layers % self.pattern_period

    def dtype(self) -> torch.dtype:
        # numpy's rules, as ``jnp.dtype`` applies them ("float" is float64);
        # numpy has no bfloat16 of its own
        name = "bfloat16" if self.param_dtype == "bfloat16" else np.dtype(self.param_dtype).name
        return getattr(torch, name)

    @property
    def input_shapes(self) -> Tuple[ShapeSpec, ...]:
        out = []
        for s in LM_SHAPES:
            if s.name == "long_500k" and not self.run_long_context:
                continue
            out.append(s)
        return tuple(out)

    @property
    def skipped_shapes(self) -> Tuple[str, ...]:
        if not self.run_long_context:
            return ("long_500k",)
        return ()


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (exact for our implementation; used for
    MODEL_FLOPS, memory budgeting and config sanity tests)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n = 0
    if cfg.embed_inputs:
        n += cfg.vocab_size * d
    n += cfg.vocab_size * d  # lm head (untied)
    per_layer = {}

    def attn_params(kv_heads):
        a = d * cfg.num_heads * hd  # q
        a += 2 * d * kv_heads * hd  # k, v
        a += cfg.num_heads * hd * d  # o
        return a

    def mla_params():
        m = cfg.mla
        a = d * m.q_lora_rank + m.q_lora_rank  # q down + norm
        a += m.q_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
        a += d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank  # kv down + norm
        a += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
        a += cfg.num_heads * m.v_head_dim * d
        return a

    def mlp_params(ff):
        return 3 * d * ff  # swiglu: w1, w3, w2

    def moe_params():
        m = cfg.moe
        p = d * m.num_experts  # router
        p += m.num_experts * 3 * d * m.d_ff_expert
        p += m.num_shared_experts * 3 * d * m.d_ff_expert
        if m.dense_residual:
            p += mlp_params(cfg.d_ff)
        return p

    def rglru_params():
        dr = cfg.d_rnn_resolved
        p = 2 * d * dr  # x proj + gate proj
        p += 4 * dr  # conv1d width 4
        p += 2 * dr  # input gate + recurrence gate projections are per-channel diag blocks
        p += dr * d  # out proj
        p += 2 * dr * dr // max(cfg.num_heads, 1) * 0  # (block-diag gates folded above)
        p += dr  # lambda
        return p

    def mlstm_params():
        # qkv + out + gates (i,f per head from x) + skip/up proj 2x
        up = 2 * d
        p = d * up * 2  # up-proj and gate branch
        p += up * 3 * up  # q,k,v over up dim
        p += 2 * up  # i,f per-channel
        p += up * d  # down proj
        return p

    def slstm_params():
        heads = max(cfg.num_heads, 1)
        dh = d // heads
        p = 4 * d * d  # i,f,z,o input projections
        p += 4 * heads * dh * dh  # block-diagonal recurrent mats
        p += 4 * d  # biases
        p += d * d  # out proj
        return p

    for kind in set(cfg.block_pattern):
        if kind == "attn" or kind == "local_attn":
            p = attn_params(cfg.num_kv_heads)
            if cfg.mla is not None:
                p = mla_params()
            if cfg.moe is not None:
                p += moe_params()
            elif cfg.d_ff > 0:
                p += mlp_params(cfg.d_ff)
            p += 2 * d  # 2 rmsnorms
            per_layer[kind] = p
        elif kind == "rglru":
            p = rglru_params()
            if cfg.d_ff > 0:
                p += mlp_params(cfg.d_ff)
            p += 2 * d
            per_layer[kind] = p
        elif kind == "mlstm":
            per_layer[kind] = mlstm_params() + d
        elif kind == "slstm":
            per_layer[kind] = slstm_params() + d
        else:
            raise ValueError(kind)

    for i in range(cfg.num_layers):
        n += per_layer[cfg.block_pattern[i % cfg.pattern_period]]
    n += d  # final norm
    return n


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token (MoE: top_k + shared of the routed pool)."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    full = param_count(cfg)
    routed_all = cfg.num_layers * m.num_experts * 3 * cfg.d_model * m.d_ff_expert
    routed_active = cfg.num_layers * m.top_k * 3 * cfg.d_model * m.d_ff_expert
    return full - routed_all + routed_active
