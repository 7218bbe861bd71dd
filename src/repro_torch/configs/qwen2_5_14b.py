"""Qwen2.5-14B [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B family card]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, head_dim=128,
    qkv_bias=True, ffn_act="silu", rope_theta=1_000_000.0,
    m2_enabled=True,
    source="hf:Qwen/Qwen2.5-0.5B",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-tiny", family="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        qkv_bias=True, ffn_act="silu",
        m2_enabled=True, m2_predictor_rank=16,
        source="hf:Qwen/Qwen2.5-0.5B (reduced)",
    )
