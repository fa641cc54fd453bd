"""granite-20b [dense] — IBM Granite 20B code model, MQA.

52L d_model=6144 48H (MQA: kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf]. The single KV head cannot shard over the 16-way
model axis — the KV projection stays replicated (the sharding rules drop
non-dividing axes) and the KV cache shards over batch only; this makes
granite-20b the framework's MQA stress test. Fed layout A; serving uses
2D (TP+FSDP) weight sharding. long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, FedPlan

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    run_long_context=False,
    microbatch=1,
    fed=FedPlan(layout="stacked", edges_per_pod=4, clients_per_edge=4, kappa1=16, kappa2=4),
    source="arXiv:2405.04324",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-20b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=1,
        d_ff=256,
        vocab_size=128,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
        fed=FedPlan(layout="stacked", edges_per_pod=2, clients_per_edge=2, kappa1=2, kappa2=2),
    )
