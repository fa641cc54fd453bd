"""recurrentgemma-9b [hybrid] — Griffin architecture: RG-LRU + local attn 1:2.

38L d_model=4096 16H (MQA kv=1, head_dim 256) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified]. Pattern (rglru, rglru, local_attn) with a
2048-token sliding window; 38 = 12×3 + 2 tail (rglru, rglru).

O(window) attention state + O(1) RG-LRU state ⇒ runs long_500k.
Fed layout A.
"""
from repro_torch.configs.base import ArchConfig, FedPlan

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    run_long_context=True,
    microbatch=1,
    fed=FedPlan(layout="stacked", edges_per_pod=4, clients_per_edge=4, kappa1=16, kappa2=4),
    source="arXiv:2402.19427",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        num_layers=5,  # 1 superblock + 2 tail — exercises the tail path
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        block_pattern=("rglru", "rglru", "local_attn"),
        window=8,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
        fed=FedPlan(layout="stacked", edges_per_pod=2, clients_per_edge=2, kappa1=2, kappa2=2),
    )
