"""Grok-1 314B [moe] — 8 experts top-2, GQA kv=8. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    num_experts=8, num_experts_per_tok=2,
    ffn_act="gelu", logit_softcap=30.0,
    m2_enabled=True,
    source="hf:xai-org/grok-1",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-tiny", family="moe",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        num_experts=4, num_experts_per_tok=2,
        moe_capacity_factor=4.0,   # no-drop for deterministic tiny tests
        ffn_act="gelu", logit_softcap=30.0,
        m2_enabled=True, m2_predictor_rank=16,
        source="hf:xai-org/grok-1 (reduced)",
    )
