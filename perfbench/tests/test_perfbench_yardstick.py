"""The frozen cost arithmetic and peaks against shapes worked by hand."""
import pytest

from pbench import cells, yardstick as Y


def test_peaks_are_the_data_sheet():
    assert Y.PEAK == {"int8": 1979e12, "f32": 67e12}
    assert Y.HBM_BW == 3.35e12


def test_gemm_cost_by_hand():
    # gpt2-large mlp_up at 4 rows: [4, 1280] @ [1280, 5120]
    c = Y.gemm_cost(4, 1280, 5120)
    assert c["ops"] == 2 * 4 * 1280 * 5120 == 52428800
    assert c["bytes"] == 4 * 1280 + 1280 * 5120 + 4 * (4 + 5120) + 4 * 4 * 5120
    # bytes-bound at decode: 6.67 MB at 3.35 TB/s
    assert Y.bound_s(c) == pytest.approx(c["bytes"] / 3.35e12)
    # ops-bound at 8192 rows of qwen2.5-14b's mlp_up
    big = Y.gemm_cost(8192, 5120, 27648)
    assert Y.bound_s(big) == pytest.approx(2 * 8192 * 5120 * 27648 / 1979e12)


def test_paged_cost_by_hand():
    # one decode row of 40 heads of 128 over 1000 keys of int8 pages (8 KV heads)
    per = Y.kv_bytes_per_position({"n_kv_heads": 8, "d_model": 5120,
                                   "n_heads": 40}, "int8")
    assert per == 2 * 8 * 132
    c = Y.paged_cost(1, 1000, 40, 128, 1000, per)
    assert c["ops"] == 4 * 128 * 40 * 1000
    assert c["bytes"] == 2 * 4 * 40 * 128 + 1000 * per
    assert Y.kv_bytes_per_position({"n_kv_heads": 8, "d_model": 5120,
                                    "n_heads": 40}, "int4") == 2 * 8 * 66


def test_site_kn_and_model_ops():
    m = cells.config("qwen2.5-14b")["port"]
    kn = Y.site_kn(m)
    assert kn == {"attn_qkv": (5120, 7168), "attn_out": (5120, 5120),
                  "mlp_up": (5120, 27648), "mlp_down": (13824, 5120)}
    ops = Y.model_ops(m, tokens=10, head_tokens=2, keys_attended=100)
    per_layer = 5120 * 7168 + 5120 * 5120 + 5120 * 27648 + 13824 * 5120
    assert ops["int8"] == 2 * per_layer * 24 * 10
    assert ops["f32"] == 2 * 5120 * 152064 * 2 + 4 * 128 * 40 * 100 * 24
    # a second of int8 peak work is 100 % of a one-second window
    assert Y.peak_share({"int8": 1979e12}, 1.0) == pytest.approx(100.0)


def test_kernel_names_map_to_layers():
    assert Y.kernel_layer("muxq_gemm_kernel<128, 64>") == "muxq_gemm"
    assert Y.kernel_layer("void paged_attention_decode<float, signed char>") == "paged_attention"
    assert Y.kernel_layer("rowwise_quantize_kernel") == "rowwise_quantize"
    assert Y.kernel_layer("ampere_sgemm_128x64_nn") == "other"
