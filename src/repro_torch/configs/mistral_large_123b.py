"""Mistral-Large 123B [dense]. [hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    qkv_bias=False, ffn_act="silu", rope_theta=1_000_000.0,
    m2_enabled=True,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-tiny", family="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        qkv_bias=False, ffn_act="silu",
        m2_enabled=True, m2_predictor_rank=16,
        source="hf:mistralai/Mistral-Large-Instruct-2407 (reduced)",
    )
