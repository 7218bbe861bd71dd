"""Mamba2-370M [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]

M2Cache's neuron-sparsity is inapplicable (no FFN) — the multi-level
weight cache still streams the in/out projections layer-wise.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    norm="rmsnorm", tie_embeddings=True,
    m2_enabled=False,   # inapplicable: attention-free, no FFN neurons
    source="arXiv:2405.21060",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-tiny", family="ssm",
        num_layers=2, d_model=128, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_conv_width=4,
        ssm_chunk=32, tie_embeddings=True,
        m2_enabled=False,
        source="arXiv:2405.21060 (reduced)",
    )
