"""The FLOP and byte counters against a count by hand at a tiny size."""
import pytest

from portbench import readers, work
from portbench.weights import param_count

CFG = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 2, "intermediate_size": 16,
       "vocab_size": 10, "mlp_act": "swiglu", "tie_word_embeddings": False}


def test_layer_params_and_bytes():
    w = work.Widths(CFG)
    # wq 8x8, wk 8x4, wv 8x4, wo 8x8, wi 8x32, wo 16x8
    assert w.layer_matmul_params == 64 + 32 + 32 + 64 + 256 + 128
    assert w.kv_token_bytes == 2 * 2 * 2 * 2 * 2       # B, K+V, kvh, hd, L
    assert w.weight_bytes == 2 * (2 * (576 + 16) + 80 + 8)
    assert param_count(CFG) == 2 * 576 + 80 + 80 + 8 + 2 * 16


def test_prefill_and_k1_by_hand():
    w = work.Widths(CFG)
    # one prompt of 3 tokens: pairs 6
    assert work.prefill_flops(w, [3], 1) == \
        2 * 3 * 2 * 576 + 4 * 4 * 2 * 6 * 2 + 2 * 8 * 10
    flops, byts = work.k1_work(w, [5], chunk=2)
    assert flops == 4 * 4 * 2 * 15 * 2
    # Q and O: 5 tokens x 2 x h hd x 2 B x L; K/V read at 2, 4, 5 tokens
    assert byts == 5 * 2 * 8 * 2 * 2 + (2 + 4 + 5) * 32


def test_decode_and_k2_by_hand():
    w = work.Widths(CFG)
    ctx = list(work.decode_contexts(prompt_len=4, n_tokens=3))
    assert ctx == [5, 6]
    assert work.decode_flops(w, ctx) == \
        2 * (2 * 2 * 576 + 2 * 8 * 10) + 4 * 4 * 2 * 11 * 2
    assert work.decode_bytes(w, 2, ctx) == 2 * w.weight_bytes + (6 + 7) * 32
    flops, byts = work.k2_work(w, ctx)
    assert flops == 4 * 4 * 2 * 11 * 2
    assert byts == 11 * 32 + 2 * (2 * 8 * 2 * 2)


def test_bound_takes_the_larger():
    assert work.bound_s(989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_percentile_counts_failures_as_missing():
    assert readers.percentile([1.0] * 9 + [2.0], 90) == pytest.approx(1.1)
    assert readers.percentile([float(i) for i in range(5)], 75) == 3.0
    assert readers.percentile([1.0] * 8 + [readers.INF] * 2, 90) is None
    assert readers.percentile([1.0] * 3 + [readers.INF], 75) is None
    assert readers.percentile([], 75) is None
