"""xlstm-350m [ssm] — xLSTM with sLSTM + mLSTM blocks.

24L d_model=1024 4H d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
Block pattern 3:1 mLSTM:sLSTM (the paper's xLSTM[a:b] notation; 350M uses
a small sLSTM fraction). d_ff=0 per the assignment: the cells carry their
own up/down projections, no separate FFN.

O(1) decode state per token (matrix memory C + normalizer) ⇒ runs the
long_500k cell. Fed layout A.
"""
from repro_torch.configs.base import ArchConfig, FedPlan

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    run_long_context=True,
    microbatch=4,
    fed=FedPlan(layout="stacked", edges_per_pod=4, clients_per_edge=4, kappa1=16, kappa2=4),
    source="arXiv:2405.04517",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="xlstm-smoke",
        family="ssm",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=96,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        mlstm_chunk=16,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
        fed=FedPlan(layout="stacked", edges_per_pod=2, clients_per_edge=2, kappa1=2, kappa2=2),
    )
