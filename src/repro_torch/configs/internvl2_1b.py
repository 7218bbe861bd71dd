"""InternVL2-1B [vlm] — InternViT (stub frontend) + InternLM2-style decoder.
[arXiv:2404.16821]

Only the language/decoder transformer is implemented: ``forward(prefix=)``
takes precomputed patch embeddings; the serving path passes none and
serves the decoder as a dense model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    qkv_bias=True, ffn_act="silu", rope_theta=1_000_000.0,
    num_prefix_embeddings=256,          # one ViT tile worth of patch tokens
    m2_enabled=True,
    source="arXiv:2404.16821",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-tiny", family="vlm",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32,
        qkv_bias=True, ffn_act="silu",
        num_prefix_embeddings=16,
        m2_enabled=True, m2_predictor_rank=16,
        source="arXiv:2404.16821 (reduced)",
    )
