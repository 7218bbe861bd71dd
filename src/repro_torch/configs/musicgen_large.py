"""MusicGen-Large [audio] — decoder-only transformer over EnCodec tokens
(4 codebooks, delay pattern), MHA (kv = heads). [arXiv:2306.05284]

The EnCodec conv codec is a stub: inputs are codebook token ids; audio
conditioning arrives as precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    norm="layernorm", ffn_act="gelu",
    num_codebooks=4, num_prefix_embeddings=64,
    m2_enabled=True,
    source="arXiv:2306.05284",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-tiny", family="audio",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=256, head_dim=32,
        norm="layernorm", ffn_act="gelu",
        num_codebooks=4, num_prefix_embeddings=8,
        m2_enabled=True, m2_predictor_rank=16,
        source="arXiv:2306.05284 (reduced)",
    )
