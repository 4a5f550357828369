"""The traffic generator: seeded, lengths in range, the same work for
every seed."""
import numpy as np
import pytest

from bench.harness.traffic import (Requests, quantile_lengths, rng,
                                   seed_words, train_rows)

BIG = 2 ** 31 + 987_654_321     # past 32 signed bits, as the driver's seeds

CHAT = {"clients": 4, "output_len": 8, "pool": 64, "follow": 0.75,
        "min_token": 2, "prompt_len": {"dist": "lognormal", "median": 512,
                                       "sigma": 0.75, "min": 128,
                                       "max": 2048}}
PACKED = {"batch": 1, "seq_len": 256, "rows": 4, "pool": 32,
          "follow": 0.75, "doc_len": {"dist": "lognormal", "median": 64,
                                      "sigma": 1.0, "min": 8, "max": 1024}}


def test_quantile_lengths_in_range_and_centred():
    x = quantile_lengths(CHAT["prompt_len"], 512)
    assert x.min() >= 128 and x.max() <= 2048
    assert abs(np.median(x) - 512) <= 2
    assert quantile_lengths({"dist": "fixed", "value": 7}, 3).tolist() == \
        [7, 7, 7]


def test_seed_words_take_any_whole_number():
    assert seed_words(BIG) != seed_words(BIG + 1)
    assert seed_words(-5) != seed_words(5)
    assert rng(2 ** 70).integers(0, 10) == rng(2 ** 70).integers(0, 10)


def test_closed_loop_is_seeded_and_same_work_per_seed():
    a, b = Requests(CHAT, 1000, BIG), Requests(CHAT, 1000, BIG)
    c = Requests(CHAT, 1000, BIG + 1)
    for i in range(6):
        assert np.array_equal(a.prompt(i), b.prompt(i))
    pa = [len(a.prompt(i)) for i in range(64)]
    pc = [len(c.prompt(i)) for i in range(64)]
    assert sorted(pa) == sorted(pc) and pa != pc   # same set, another order
    p = a.prompt(3)
    assert p.dtype == np.int32 and p.min() >= 2 and p.max() < 1000
    assert a.stagger() == 2


def test_train_rows_packed_and_seeded():
    r1 = train_rows(PACKED, 500, BIG, 4)
    r2 = train_rows(PACKED, 500, BIG, 4)
    assert r1["tokens"].shape == (4, 256) == r1["labels"].shape
    assert np.array_equal(r1["tokens"], r2["tokens"])
    assert np.array_equal(r1["tokens"][:, 1:], r1["labels"][:, :-1])
    assert r1["tokens"].max() < 500
    assert not np.array_equal(train_rows(PACKED, 500, BIG + 1, 4)["tokens"],
                              r1["tokens"])


def test_every_run_of_pool_requests_holds_each_length_once():
    a = Requests(CHAT, 1000, BIG)
    pool = sorted(quantile_lengths(CHAT["prompt_len"], CHAT["pool"]))
    for start in (0, 64, 128):
        got = sorted(len(a.prompt(i)) for i in range(start, start + 64))
        assert got == pool
    assert a.max_prompt == max(pool) <= 2048


def test_unknown_distribution_refused():
    with pytest.raises(ValueError):
        quantile_lengths({"dist": "pareto"}, 4)
