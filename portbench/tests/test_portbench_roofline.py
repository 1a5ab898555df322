"""The yardstick's counts against shapes worked by hand."""
import pytest

from portbench import readers, roofline as R


def desc(moe=None):
    L = {"n_q": 4, "d_ff": 128,
         "live_per_col": {"q": 2, "k": 4, "v": 4, "o": 3, "gate": 2,
                          "up": 2, "down": 4},
         "fold": {"q": [64, 64], "k": [64, 32], "v": [64, 32],
                  "o": [64, 64], "gate": [64, 128], "up": [64, 128],
                  "down": [128, 64]}}
    return {"d_model": 64, "head_dim": 16, "n_kv": 2, "vocab": 100,
            "block": 16, "layers": [L], "moe": moe}


def test_bound_is_the_larger_of_bytes_and_operations():
    assert R.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert R.bound_s(0, 989e12) == pytest.approx(1.0)
    assert R.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_projection_call_counts_live_tiles_once_and_real_rows():
    # gate (64, 128): 2 live blocks in each of 8 columns = 16 tiles
    b, ops = R.projection_call(desc(), 0, "gate", rows=4)
    assert b == 16 * 256 * 2 + 4 * (64 + 128) * 2
    assert ops == 2 * 4 * 16 * 256
    b8, _ = R.projection_call(desc(), 0, "gate", rows=4, experts=8)
    assert b8 == 8 * 16 * 256 * 2 + 4 * (64 + 128) * 2


def test_paged_attention_reads_each_cache_row_once():
    b, ops = R.paged_attention_call(desc(), 0, [10, 20])
    assert b == 2 * 30 * 2 * 16 * 2 + 2 * 2 * 4 * 16 * 2
    assert ops == 4 * 30 * 4 * 16
    assert R.decode_ticks({"lens": [5, 7], "ticks": 2}) == [[6, 8], [7, 9]]


def test_step_call_of_one_decode_token():
    # one row, 9 cached positions read, 1 written, 10 query-key pairs
    b, ops = R.step_call(desc(), 1, 9, 1, 10)
    # live tiles of q (2 of 4 in 4 columns), k, v (4 in 2), o (3 in 4)
    attn_w = (2 * 4 + 4 * 2 + 4 * 2 + 3 * 4) * 256
    ffn = (16 + 16 + 16) * 256 * 2           # live tiles of gate, up, down
    head = 64 * 100 * 2
    assert b == head + 64 * 2 + 100 * 2 + attn_w * 2 + 10 * 2 * 2 * 16 * 2 \
        + ffn
    assert ops == 2 * 64 * 100 + 2 * attn_w + 4 * 10 * 4 * 16 + 2 * ffn / 2


def test_kernel_share_by_kind_of_call():
    ctx = {"desc": desc(), "serving": {"prefill_multiple": 16},
           "trace": {"by_class_s": {"k1": 2e-6, "k3": 1e-6},
                     "by_kind_class_s": {"decode": {"k1": 1.5e-6,
                                                    "k3": 1e-6},
                                         "prefill": {"k1": 0.5e-6}},
                     "calls": [{"kind": "decode", "lens": [3], "ticks": 2},
                               {"kind": "prefill", "start": 0, "n": 5}],
                     "wall_s": 1e-3, "busy_s": 4e-4,
                     "counters0": {}, "counters1": {}}}
    def k1(rows):
        return sum(R.bound_s(*R.projection_call(desc(), 0, name, r))
                   for r in rows for name in ("gate", "up", "down"))
    assert readers.k1_bound(ctx, "decode") == pytest.approx(k1((1, 1)))
    assert readers.k1_bound(ctx, "prefill") == pytest.approx(k1((5,)))
    assert readers.kernel_share(ctx, "k1", readers.k1_bound, "decode") == \
        pytest.approx(100 * k1((1, 1)) / 1.5e-6)
    assert readers.kernel_share(ctx, "k1", readers.k1_bound, "prefill") \
        == pytest.approx(100 * k1((5,)) / 0.5e-6)
    k3 = sum(R.bound_s(*R.paged_attention_call(desc(), 0, [n]))
             for n in (4, 5))
    assert readers.k3_bound(ctx, "decode") == pytest.approx(k3)
    assert readers.kernel_share(ctx, "k3", readers.k3_bound, "prefill") \
        is None
    assert readers.idle_share(ctx) == pytest.approx(0.6)
    assert readers.kernel_share(ctx, "k6", readers.k6_bound,
                                "prefill") is None
    ctx["trace"]["by_kind_class_s"] = None     # markers and calls disagree
    assert readers.kernel_share(ctx, "k1", readers.k1_bound,
                                "decode") is None


def test_kernel_classes_by_name():
    assert R.kernel_class("void block_sparse_kernel<__nv_bfloat16, 16, 64>"
                          "(...)") == "k1"
    assert R.kernel_class("quant_block_sparse_kernel<float,16,16>") == \
        "other"
    assert R.kernel_class("paged_attention_merge_kernel") == "k3"
    assert R.kernel_class("grouped_shared_x_kernel") == "k6"
    assert R.kernel_class("ragged_kernel<float>") == "k7"
    assert R.kernel_class("at::cuda::spin_kernel(long)") == "marker"
    assert R.kernel_class("sm90_xmma_gemm_bf16bf16") == "gemm"
    assert R.busy_s([(0, 2), (1, 3), (5, 6)]) == 4
