"""Llama-4 Maverick 400B-A17B [moe] — 128 experts top-1 + shared expert,
early-fusion multimodal (frontend stubbed). [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    num_experts=128, num_experts_per_tok=1, shared_expert_d_ff=8192,
    ffn_act="silu", rope_theta=500_000.0,
    m2_enabled=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-tiny", family="moe",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32,
        num_experts=4, num_experts_per_tok=1, shared_expert_d_ff=256,
        moe_capacity_factor=4.0,   # no-drop for deterministic tiny tests
        ffn_act="silu",
        m2_enabled=True, m2_predictor_rank=16,
        source="hf:meta-llama/Llama-4-Scout-17B-16E (reduced)",
    )
