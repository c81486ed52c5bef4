"""perfbench/flops.py against hand-worked bounds: the forward K1-K3 rows of
PERF.md's kernel table (4 D FLOPs a visible pair and head at 989 TFLOP/s),
and a backward counted per attention call, so that one fused kernel and the
K5 + K6 pair are judged on the same work."""

import pytest

from perfbench import core
from perfbench import flops as F


@pytest.mark.parametrize("shape, S, causal, ms", [
    ((1, 1416, 24, 128), 1432, True, 0.0125),     # K1, the serving prefill
    ((1, 8192, 24, 128), 8192, True, 0.4170),     # K1, stage 2
    ((1, 8192, 28, 128), 8192, True, 0.4864),     # K1, stage 3 (GQA 28/4)
    ((1, 6152, 28, 128), 6168, True, 0.2743),     # K1, the audio-visual prefill
    ((16, 730, 24, 64), 730, False, 0.0530),      # K2, DINOv2
    ((16, 729, 16, 72), 729, False, 0.0396),      # K3, SigLIP
])
def test_forward_rows_of_the_kernel_table(shape, S, causal, ms):
    B, T, H, D = shape
    assert F.bound_s(*F.attn_fwd(B, T, S, H, H, D, causal)) * 1e3 == pytest.approx(ms, abs=6e-5)


def test_pairs_at_a_query_offset():
    # the second rank's block of a 2-way split of T=8192: 3/4 of the pairs
    whole = F.attn_pairs(8192, 8192, True)
    assert F.attn_pairs(4096, 8192, True, 4096) + F.attn_pairs(4096, 8192, True) == whole
    assert F.attn_pairs(4096, 8192, True, 4096) == 4096 * 4096 + 4096 * 4097 // 2
    assert F.attn_pairs(3, 2, True) == 1 + 2 + 2  # rows past the last key see all S


def test_backward_is_counted_per_call():
    B, T, Hq, Hkv, D = 1, 8192, 28, 4, 128
    fwd = F.attn_fwd(B, T, T, Hq, Hkv, D, True)[0]
    bwd = F.attn_bwd(B, T, T, Hq, Hkv, D, True)[0]
    assert bwd == pytest.approx(2.5 * fwd)  # 10 D against 4 D a pair
    rec = {"q": (B, T, Hq, D), "k": (B, T, Hkv, D), "causal": True, "q_offset": 0, "lse": False}
    pair = F.launch_bound_s({**rec, "name": "flash_dq_kernel"}) + \
        F.launch_bound_s({**rec, "name": "flash_dkv_kernel"})
    fused = F.bound_s(*F.attn_bwd(B, T, T, Hq, Hkv, D, True))
    assert pair == fused


def test_roofline_never_counts_kernels_it_did_not_time():
    class Run:
        trace = {"kernels": [("void flash_fwd_bf16_sm90_kernel<Cfg>(FwdParams)", 1e-3)]}
        launches = [{"name": "flash_kernel", "q": (1, 1416, 24, 128), "k": (1, 1432, 4, 128),
                     "causal": True, "q_offset": 0, "lse": True}]

    pct = F.roofline_pct(Run, F.FORWARD, ("flash_fwd",))
    assert 0 < pct <= 100
    Run.trace = {"kernels": []}
    assert F.roofline_pct(Run, F.FORWARD, ("flash_fwd",)) is None


def test_lm_flops_is_two_per_parameter_and_row_plus_attention():
    class LM:
        name, hidden_size, num_heads, num_kv_heads, head_dim = "qwen2", 64, 4, 2, 16
        intermediate_size, num_layers, vocab_size = 128, 2, 100

    class Model:
        lm = LM

    per_layer = 64 * (2 * 64 + 2 * 32) + 3 * 64 * 128
    want = 2 * (2.0 * 10 * per_layer + 4 * 16 * 4 * 55) + 2 * 64 * 100
    assert core.lm_family(Model).forward_flops(LM, 10) == want
