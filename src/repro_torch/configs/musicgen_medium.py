"""musicgen-medium [audio] — MusicGen 1.5B decoder over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24 = MHA) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf]. The EnCodec audio frontend is a STUB per the
assignment: ``input_specs()`` feeds precomputed frame embeddings
(B, S, d_model); the head predicts the 2048-way codebook.

Fed layout A. long_500k skipped (full attention).
"""
from repro_torch.configs.base import ArchConfig, FedPlan

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    embed_inputs=False,  # EnCodec frontend stubbed: frame embeddings in
    run_long_context=False,
    microbatch=4,
    fed=FedPlan(layout="stacked", edges_per_pod=4, clients_per_edge=4, kappa1=16, kappa2=4),
    source="arXiv:2306.05284",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="musicgen-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=64,
        embed_inputs=False,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
        fed=FedPlan(layout="stacked", edges_per_pod=2, clients_per_edge=2, kappa1=2, kappa2=2),
    )
