"""Command-R 35B [dense] — GQA, no bias, parallel attn+FFN block, layernorm.
[hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000, head_dim=128,
    qkv_bias=False, ffn_act="silu", norm="layernorm",
    parallel_block=True, tie_embeddings=True, rope_theta=8_000_000.0,
    m2_enabled=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-tiny", family="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        qkv_bias=False, ffn_act="silu", norm="layernorm",
        parallel_block=True, tie_embeddings=True,
        m2_enabled=True, m2_predictor_rank=16,
        source="hf:CohereForAI/c4ai-command-r-v01 (reduced)",
    )
