"""The cost counts against hand counts at the three cells' shapes."""
import pytest

from portbench.cost import kernels as K
from portbench.cost import model as MD
from portbench.cost import peaks as PK
from portbench.harness import spec as SP

BENCH = SP.benchmark()
QWEN = SP.config(BENCH, "qwen2.5-14b-2l-bf16")
MISTRAL = SP.config(BENCH, "mistral-large-123b-11l-bf16")
QWEN48 = SP.config(BENCH, "qwen2.5-14b-bf16")


def test_tiers_of_both_configs():
    assert K.tier_sizes(13824, QWEN["m2"]) == {
        "k": 4147, "fp": 1037, "int8": 1037, "int4": 2073}
    assert K.tier_sizes(28672, MISTRAL["m2"]) == {
        "k": 8602, "fp": 2150, "int8": 2150, "int4": 4302}


def test_qmatmul_at_the_decode_batch():
    flops, nbytes = K.qmatmul_ffn(QWEN, 192)
    assert flops == 2 * 192 * 5120 * 4147 * 3
    rows = 1037 * 2 * 5120 + 1037 * 5120 + 2073 * 5120 // 2
    scales = (1037 + 2073) * 4
    assert nbytes == 3 * (rows + scales) + 192 * 5120 * (2 + 4)


def test_qmatmul_at_a_mistral_prompt():
    flops, _ = K.qmatmul_ffn(MISTRAL, 4096)
    assert flops == 2 * 4096 * 12288 * 8602 * 3


def test_flash_decode_reads_each_valid_slot_once():
    flops, nbytes = K.flash_decode(QWEN, [30721] * 192)
    assert nbytes == 192 * 30721 * 8 * 128 * 2 * 2 + 192 * 40 * 128 * 6
    assert flops == 4 * 40 * 128 * 192 * 30721


@pytest.mark.parametrize("S", [2048, 8192])
def test_flash_attention_counts_causal_pairs(S):
    flops, nbytes = K.flash_attention(QWEN, S)
    assert flops == 4 * 40 * 128 * S * (S + 1) // 2
    assert nbytes == S * 128 * 2 * (2 * 40 + 2 * 8)


def test_decode_step_is_bound_by_the_cache():
    flops, nbytes = MD.decode_step(QWEN, [30720] * 192)
    kv = 2 * 192 * 30720 * 8 * 128 * 2 * 2
    weights = 2 * (5120 * 7168 + 5120 * 5120) * 2 + 152064 * 5120 * 2
    assert kv + weights < nbytes < (kv + weights) * 1.02
    t = PK.roofline_s(flops, nbytes, PK.H100_SXM)
    assert t == nbytes / 3.35e12
    assert 0.0150 < t < 0.0156


def test_prefill_counts_only_the_last_positions_logits():
    one, _ = MD.prefill(QWEN48, 2048)
    per_layer = MD.prefill(QWEN, 2048)[0] - 2 * 5120 * 152064
    assert one == 48 * per_layer / 2 + 2 * 5120 * 152064


def test_prefill_is_bound_by_operations():
    S = 4096
    flops, nbytes = MD.prefill(MISTRAL, S)
    per_layer = 2 * S * (12288 * (96 + 16) * 128 + 96 * 128 * 12288
                         + 12288 * 64 + 64 * 28672 + 3 * 12288 * 8602) \
        + 4 * 96 * 128 * S * (S + 1) // 2
    assert flops == 11 * per_layer + 2 * 12288 * 32768
    assert PK.roofline_s(flops, nbytes, PK.H100_SXM) == flops / 989e12
