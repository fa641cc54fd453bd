"""arctic-480b [moe] — Snowflake Arctic base.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts
top-2 **plus a dense FFN residual in parallel** (Arctic's dense-MoE hybrid)
[hf:Snowflake/snowflake-arctic-base; hf].

Fed layout B (cross-silo): one client per pod; EP over the model axis
(128 experts / 16 = 8 per chip), FSDP over data. long_500k skipped
(full attention, DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ArchConfig, FedPlan, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,  # dense residual branch width
    vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True),
    run_long_context=False,
    microbatch=16,
    fed=FedPlan(layout="sharded", edges_per_pod=1, clients_per_edge=1, kappa1=16, kappa2=4),
    source="hf:Snowflake/snowflake-arctic-base",
)


def smoke() -> ArchConfig:
    """Same family (dense-residual MoE), CPU-sized."""
    return ArchConfig(
        name="arctic-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, dense_residual=True),
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
        fed=FedPlan(layout="sharded", edges_per_pod=1, clients_per_edge=1, kappa1=2, kappa2=2),
    )
