"""Model configuration system.

The port's own copy of ``repro/configs/base.py``'s ``ModelConfig`` (the
port imports nothing of the JAX package). Every architecture the port
serves has one module in this package defining a ``ModelConfig`` with the
exact published dimensions plus a ``tiny()`` reduced variant used by tests.

The config is deliberately a single flat dataclass covering all six
architecture families (dense / moe / ssm / hybrid / vlm / audio); family-
specific fields are ignored by families that do not use them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                    # query heads (0 for attn-free archs)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # --- numerics / block details -------------------------------------
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    ffn_act: str = "silu"             # silu | relu (ReGLU) | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    parallel_block: bool = False      # command-r style parallel attn+FFN
    logit_softcap: float = 0.0
    tie_embeddings: bool = False

    # --- MoE ------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    shared_expert_d_ff: int = 0       # llama4-style shared expert (0 = none)

    # --- SSM (mamba2) ----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (recurrentgemma) ------------------------------------------
    block_pattern: Sequence[str] = ("attn",)   # repeating layer-kind pattern
    lru_width: int = 0                # RG-LRU recurrence width (0 -> d_model)
    window_size: int = 0              # local attention window (0 = global)

    # --- multimodal stubs --------------------------------------------------
    num_prefix_embeddings: int = 0    # VLM patch / audio frame embeddings
    num_codebooks: int = 0            # musicgen EnCodec codebooks

    # --- M2Cache (the paper's technique) -----------------------------------
    m2_enabled: bool = False          # dynamic sparse mixed-precision FFN
    m2_active_ratio: float = 0.30     # fraction of FFN neurons active / token
    m2_ratio_fp16: float = 0.25       # of the active set (paper Fig. 9 setup)
    m2_ratio_int8: float = 0.25
    m2_ratio_int4: float = 0.50
    m2_predictor_rank: int = 64       # Deja-Vu low-rank predictor rank

    # --- citation -----------------------------------------------------------
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "hybrid" and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        assert self.family in ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
        if self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def layer_kinds(self) -> tuple:
        """Per-layer kind sequence, e.g. ('rglru','rglru','attn',...)."""
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.num_layers))
        if self.family == "hybrid":
            pat = tuple(self.block_pattern)
            out = []
            while len(out) < self.num_layers:
                out.extend(pat)
            return tuple(out[: self.num_layers])
        return tuple("attn" for _ in range(self.num_layers))

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.d_model * self.ssm_expand

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, f, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        for kind in self.layer_kinds:
            if kind == "attn":
                hd = self.head_dim
                per_layer += d * self.num_heads * hd        # W_q
                per_layer += 2 * d * self.num_kv_heads * hd  # W_k, W_v
                per_layer += self.num_heads * hd * d         # W_o
            elif kind == "rglru":
                w = self.lru_width
                per_layer += 2 * d * w + w * d + 3 * w * w + 2 * w  # proj + gates
            elif kind == "ssm":
                di, ns, nh = self.d_inner, self.ssm_state, self.ssm_nheads
                per_layer += d * (2 * di + 2 * ns + nh)  # in_proj (x,z,B,C,dt)
                per_layer += di * d                       # out_proj
                per_layer += self.ssm_conv_width * (di + 2 * ns)
            # FFN
            if kind != "ssm":
                if self.num_experts:
                    per_layer += self.num_experts * 3 * d * f
                    per_layer += d * self.num_experts            # router
                    if self.shared_expert_d_ff:
                        per_layer += 3 * d * self.shared_expert_d_ff
                else:
                    per_layer += 3 * d * f
        return emb + per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k / M2Cache sparse)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full = self.param_count()
        dense_moe = self.num_layers * self.num_experts * 3 * d * f
        active_moe = self.num_layers * self.num_experts_per_tok * 3 * d * f
        return full - dense_moe + active_moe


# ---------------------------------------------------------------------------
_REGISTRY: dict = {}

#: every architecture of the reference: its dense-attention configs, its two
#: MoE configs, its hybrid, SSM and audio ones
_MODULE_FOR = {
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2.5-32b": "qwen2_5_32b",
    "command-r-35b": "command_r_35b",
    "mistral-large-123b": "mistral_large_123b",
    "internvl2-1b": "internvl2_1b",
    "grok-1-314b": "grok_1_314b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-370m": "mamba2_370m",
    "musicgen-large": "musicgen_large",
}

#: the reference's architecture ids in its order (repro/configs/base.py:
#: 152-163)
ASSIGNED_ARCHS = (
    "qwen2.5-14b",
    "command-r-35b",
    "grok-1-314b",
    "qwen2.5-32b",
    "mistral-large-123b",
    "internvl2-1b",
    "recurrentgemma-2b",
    "mamba2-370m",
    "musicgen-large",
    "llama4-maverick-400b-a17b",
)

#: families whose configs ``get_config`` loads but no entry point serves:
#: musicgen's (B, K, S) codebook prompts run through ``forward`` only
FORWARD_ONLY = ("audio",)


def _family(name: str) -> str:
    return importlib.import_module(
        f"repro_torch.configs.{_MODULE_FOR[name]}").CONFIG.family


#: the ``--arch`` values the port serves
SERVED = tuple(n for n in _MODULE_FOR if _family(n) not in FORWARD_ONLY)


def check_served(cfg) -> None:
    """Raise NotImplementedError for a config of a ``FORWARD_ONLY`` family:
    the reference cannot serve musicgen's codebook prompts either. Its CLIs
    draw (B, S) prompts, which its codebook embedding refuses
    (repro/launch/serve.py:58-59, repro/models/transformer.py:672-675),
    and its runner's decode broadcasts a (B, K) argmax to (B, K, 1)
    (repro/core/engine_model.py:184-187)."""
    if cfg.family in FORWARD_ONLY:
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}) runs through "
            "models.transformer.forward only: the reference cannot serve it "
            "either (its CLIs draw (B, S) prompts, which its codebook "
            "embedding refuses, and its runner broadcasts a (B, K) argmax "
            "to (B, K, 1))")


def get_config(name: str, tiny: bool = False) -> ModelConfig:
    """Load an architecture config by its id (``--arch`` value)."""
    if name not in _MODULE_FOR:
        raise KeyError(f"{name!r} is no config of the reference; the port "
                       f"loads {list(_MODULE_FOR)}")
    key = (name, tiny)
    if key not in _REGISTRY:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
        _REGISTRY[(name, False)] = mod.CONFIG
        _REGISTRY[(name, True)] = mod.tiny()
    return _REGISTRY[key]


def list_archs():
    return list(ASSIGNED_ARCHS)


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
