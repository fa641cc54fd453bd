"""deepseek-v3-671b [moe] — DeepSeek-V3.

61L d_model=7168 128H (MLA) d_ff=2048(expert) vocab=129280, MoE: 1 shared +
256 routed experts top-8 [arXiv:2412.19437; hf]. Multi-head Latent
Attention with the standard V3 dims (q_lora 1536, kv_lora 512,
qk_nope/rope 128/64, v 128); the absorbed-matrix decode path caches only
the 512+64 latent per token. The MTP (multi-token-prediction) head is
omitted — it is orthogonal to the aggregation protocol under study
(DESIGN.md §Arch-applicability).

Fed layout B (cross-silo): one client per pod; EP 16-way (256/16 = 16
experts per chip), FSDP over data. long_500k skipped (full attention).
"""
from repro_torch.configs.base import ArchConfig, FedPlan, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048, num_shared_experts=1),
    mla=MLAConfig(
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    ),
    run_long_context=False,
    microbatch=16,
    fed=FedPlan(layout="sharded", edges_per_pod=1, clients_per_edge=1, kappa1=16, kappa2=4),
    source="arXiv:2412.19437",
)


def smoke() -> ArchConfig:
    """Same family (MLA + shared/routed MoE), CPU-sized."""
    return ArchConfig(
        name="deepseek-v3-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=64,
        vocab_size=160,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64, num_shared_experts=1),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
        fed=FedPlan(layout="sharded", edges_per_pod=1, clients_per_edge=1, kappa1=2, kappa2=2),
    )
