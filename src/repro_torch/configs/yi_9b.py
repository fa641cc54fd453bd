"""yi-9b [dense] — Yi-9B, llama-arch with GQA.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
[arXiv:2403.04652; hf]. Fed layout A. long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, FedPlan

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    run_long_context=False,
    microbatch=1,
    fed=FedPlan(layout="stacked", edges_per_pod=4, clients_per_edge=4, kappa1=16, kappa2=4),
    source="arXiv:2403.04652",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="yi-9b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=160,
        vocab_size=128,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
        fed=FedPlan(layout="stacked", edges_per_pod=2, clients_per_edge=2, kappa1=2, kappa2=2),
    )
