"""RecurrentGemma-2B [hybrid] — RG-LRU recurrent blocks + local attention,
pattern 2 recurrent : 1 attention. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    ffn_act="gelu", block_pattern=("rglru", "rglru", "attn"),
    lru_width=2560, window_size=2048, tie_embeddings=True,
    m2_enabled=True,
    source="arXiv:2402.19427",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-tiny", family="hybrid",
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=1,
        d_ff=256, vocab_size=512, head_dim=32,
        ffn_act="gelu", block_pattern=("rglru", "rglru", "attn"),
        lru_width=128, window_size=64, tie_embeddings=True,
        m2_enabled=True, m2_predictor_rank=16,
        source="arXiv:2402.19427 (reduced)",
    )
