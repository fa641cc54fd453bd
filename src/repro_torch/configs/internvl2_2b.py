"""internvl2-2b [vlm] — InternVL2 (InternViT-300M + InternLM2-1.8B).

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf]. The InternViT vision frontend is a STUB per the
assignment: ``input_specs()`` feeds precomputed patch embeddings
(B, S, d_model) directly into the LM backbone (embed_inputs=False).

Fed layout A (stacked clients), 4 edges/pod × 4 clients/edge.
long_500k skipped (full attention).
"""
from repro_torch.configs.base import ArchConfig, FedPlan

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    embed_inputs=False,  # ViT frontend stubbed: patch embeddings in
    run_long_context=False,
    microbatch=4,
    fed=FedPlan(layout="stacked", edges_per_pod=4, clients_per_edge=4, kappa1=16, kappa2=4),
    source="arXiv:2404.16821",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="internvl2-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=96,
        embed_inputs=False,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
        fed=FedPlan(layout="stacked", edges_per_pod=2, clients_per_edge=2, kappa1=2, kappa2=2),
    )
