"""The metric arithmetic: tails over all samples, rates over the whole
window, busy time as a union, the work counts on known shapes, and the
readers over a synthetic trace."""
import math

import pytest

from bench.harness import work
from bench.harness.cell import Record
from bench.harness.spec import load_metric
from bench.harness.stats import gaps, percentile, rate, union_length
from bench.harness.trace import Event, Slice


def test_percentile_takes_every_sample():
    v = list(range(1, 101))
    assert percentile(v, 95) == 95
    assert percentile(v + [1000], 95) == 96
    assert percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        percentile([], 95)


def test_rate_over_the_whole_window():
    assert rate(300, 1.5) == 200
    with pytest.raises(ValueError):
        rate(1, 0)


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert union_length(spans) == 4
    assert gaps(spans, 0, 9) == [(6, 9), (3, 5)]


def test_work_on_known_shapes():
    assert work.attended_pairs(4, 4) == 10
    assert work.attended_pairs(4, 4, causal=False) == 16
    f, b = work.flash_fwd(1, 2, 1, 4, 4, 8)
    assert f == 4 * 8 * 20
    assert b == 2 * (2 * 64 + 2 * 32) + 4 * 8
    fb, _ = work.flash_bwd(1, 2, 1, 4, 4, 8)
    assert fb == 10 * 8 * 20
    assert work.roofline_s(989e12, 0) == pytest.approx(1.0)
    assert work.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.paged_decode_bytes(10, 2, 4, 2, 8) == 2 * 10 * 2 * 8 * 2 \
        + 2 * 2 * 2 * 4 * 8


def test_model_flops_count_params_and_pairs():
    s = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
         "d_ff": 16, "vocab": 32, "n_layers": 3, "n_experts": 0,
         "top_k": 0}
    layer = 8 * 8 * 2 + 8 * 4 * 2 + 3 * 8 * 16
    assert work.matmul_params(s) == (layer, 8 * 32)
    assert work.forward_flops(s, 5, 7) == 2 * (3 * layer + 256) * 5 + \
        4 * 4 * 2 * 3 * 7
    assert work.train_step_flops(s, 2, 4) == 3 * work.forward_flops(
        s, 8, 2 * 10)
    moe = dict(s, n_experts=4, top_k=2)
    assert work.matmul_params(moe)[0] == 8 * 8 * 2 + 8 * 4 * 2 + 8 * 4 + \
        3 * 2 * 8 * 16


def _slice():
    dev = [Event("flash_fwd_wgmma_kernel", 0.0, 0.001),
           Event("flash_bwd_dq_wgmma_kernel", 0.002, 0.004),
           Event("flash_bwd_dkv_wgmma_kernel", 0.004, 0.007),
           Event("paged_decode_split_kernel", 0.007, 0.008),
           Event("decode_combine_kernel", 0.008, 0.0085)]
    sl = Slice(device=dev, annotations=[Event("bench::slice", 0, 0.01)],
               host_ops=[], start=0.0, end=0.01)
    sl.counts = {"batch": 1, "seq": 64, "output_tokens": 5,
                 "decode_live": [100], "decode_rows": [5]}
    return sl


SIZES = {"n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "n_layers": 2}


def _read(name, **kw):
    rec = Record(cell=None, sizes=SIZES, window=kw.get("window", {}),
                 window_s=kw.get("window_s", 2.0), slice=kw.get("slice"))
    return load_metric(name).read(rec)


def test_readers_on_a_synthetic_trace():
    sl = _slice()
    assert _read("idle_share.train", slice=sl) == pytest.approx(
        100 * (1 - 0.0075 / 0.01))
    assert _read("launches_per_token.serve", slice=sl) == 1.0
    f, b = work.flash_fwd(1, 4, 2, 64, 64, 16)
    assert _read("flash_fwd_roofline.train", slice=sl) == pytest.approx(
        100 * work.roofline_s(f, b) / 0.001)
    f, b = work.flash_bwd(1, 4, 2, 64, 64, 16)
    assert _read("flash_bwd_roofline.train", slice=sl) == pytest.approx(
        100 * work.roofline_s(f, b) / 0.005)
    nb = 2 * work.paged_decode_bytes(100, 5, 4, 2, 16)
    assert _read("paged_decode_roofline.serve", slice=sl) == pytest.approx(
        100 * nb / work.HBM_BYTES_S / 0.0015)
    assert _read("mfu.train", window={"model_flops": 989e12},
                 window_s=4.0) == pytest.approx(25.0)
    assert _read("prefill_time_share.serve",
                 window={"spans": {"prefill": 1.0, "decode": 3.0}}) == 25.0


@pytest.mark.parametrize("name", [
    "idle_share.serve", "launches_per_token.serve", "flash_fwd_roofline.train",
    "flash_bwd_roofline.train", "paged_decode_roofline.serve", "mfu.serve",
    "prefill_time_share.serve"])
def test_readers_find_nothing_and_return_nothing(name):
    empty = Slice(device=[], annotations=[], host_ops=[], start=0, end=1)
    assert _read(name, slice=None) is None
    assert _read(name, slice=empty) is None


def test_nothing_reads_past_100_percent_on_a_busy_slice():
    sl = _slice()
    for name in ("idle_share.train", "flash_fwd_roofline.train",
                 "flash_bwd_roofline.train", "paged_decode_roofline.serve"):
        v = _read(name, slice=sl)
        assert 0 <= v <= 100 and not math.isnan(v)
