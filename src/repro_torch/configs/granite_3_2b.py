"""granite-3-2b [dense] — IBM Granite 3.0 2B base, GQA.

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base; hf]. Fed layout A. long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, FedPlan

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    run_long_context=False,
    microbatch=4,
    fed=FedPlan(layout="stacked", edges_per_pod=4, clients_per_edge=4, kappa1=16, kappa2=4),
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-3-2b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=99,  # odd vocab like the full config's 49155
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
        fed=FedPlan(layout="stacked", edges_per_pod=2, clients_per_edge=2, kappa1=2, kappa2=2),
    )
