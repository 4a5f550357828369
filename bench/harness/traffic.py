"""The one traffic generator: every mix is a JSON file of parameters.

Lengths are drawn as a FIXED set for a mix, the quantiles of its
distribution, and only their order and the tokens follow the seed: every
seed asks for the same work, in another order, so runs of two seeds
differ no more than two runs of one.

Token ids follow the synthetic LM stream of the port's data pipeline
(``repro_torch.data.pipeline.SyntheticLM``, copied here as arithmetic): a
fixed random bigram table, each next token its predecessor's successor
with probability ``follow``, else uniform; a document restarts the chain.
"""
from __future__ import annotations

import math
import statistics

import numpy as np

def seed_words(seed: int, *salt: int) -> list[int]:
    """``seed`` (any whole number, also past 64 bits) and ``salt`` as the
    32-bit words numpy's SeedSequence takes."""
    words = []
    for v in (seed, *salt):
        v = int(v)
        sign = 1 if v < 0 else 0
        v = abs(v)
        words.append(sign)
        while True:
            words.append(v & 0xFFFFFFFF)
            v >>= 32
            if not v:
                break
    return words


def rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        seed_words(seed, *salt)))


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``dist``:
    ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
    ``{"dist": "fixed", "value"}``, as int64, clipped to [min, max]."""
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    if kind != "lognormal":
        raise ValueError(f"unknown length distribution {kind!r}")
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = dist["median"] * np.exp(dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def bigram_table(vocab: int, seed: int) -> np.ndarray:
    return rng(seed, 0xB16).integers(0, vocab, size=vocab, dtype=np.int64)


def markov_rows(table: np.ndarray, starts: np.ndarray, follow: float,
                g: np.random.Generator) -> np.ndarray:
    """(rows, n) tokens: each row a bigram chain over ``table`` that
    restarts at every True of ``starts`` (rows, n) (position 0 always
    starts)."""
    rows, n = starts.shape
    vocab = table.shape[0]
    rand = g.integers(0, vocab, size=(rows, n), dtype=np.int64)
    keep = g.random((rows, n)) < follow
    out = np.empty((rows, n), np.int64)
    out[:, 0] = rand[:, 0]
    for t in range(1, n):
        nxt = np.where(keep[:, t], table[out[:, t - 1]], rand[:, t])
        out[:, t] = np.where(starts[:, t], rand[:, t], nxt)
    return out


# ---------------------------------------------------------------------------
# training: rows packed from documents
# ---------------------------------------------------------------------------

def train_rows(mix: dict, vocab: int, seed: int, n_rows: int) -> dict:
    """``n_rows`` packed rows of ``seq_len + 1`` tokens for a training mix:
    ``{"seq_len", "doc_len": <dist>, "follow", "pool"}``.  Documents take
    their lengths from a fixed pool of ``pool`` quantiles in a seeded
    order, packed back to back (a document cut at a row's end goes on in
    the next row).  -> {"tokens": (n_rows, S), "labels": (n_rows, S)}."""
    S = int(mix["seq_len"])
    g = rng(seed, 0x7A1)
    pool = quantile_lengths(mix["doc_len"], int(mix["pool"]))
    order = g.permutation(len(pool))
    starts = np.zeros((n_rows, S + 1), bool)
    pos, k = 0, 0
    total = n_rows * (S + 1)
    flat = starts.reshape(-1)
    while pos < total:
        flat[pos] = True
        pos += int(pool[order[k % len(pool)]])
        k += 1
    starts[:, 0] = True
    toks = markov_rows(bigram_table(vocab, seed), starts,
                       float(mix["follow"]), g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# serving: requests from a closed loop of clients
# ---------------------------------------------------------------------------

class Requests:
    """The requests of a serving mix, a pure function of (seed, i):

    ``{"prompt_len": <dist>, "pool", "output_len", "clients", "follow",
    "min_token"}``, sent by ``clients`` clients in a closed loop (each
    sends its next request when its last completes, zero think time).
    Prompt lengths are a fixed pool of quantiles in a seeded order, so
    every seed asks for the same work in another order."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = seed
        self.output_len = int(mix["output_len"])
        self.clients = int(mix["clients"])
        self.lengths = quantile_lengths(mix["prompt_len"], int(mix["pool"]))
        self.order = rng(seed, 0x5E7).permutation(len(self.lengths))
        self.table = bigram_table(vocab, seed)
        self.sent = 0

    @property
    def max_prompt(self) -> int:
        return int(self.lengths.max())

    def prompt(self, i: int) -> np.ndarray:
        n = int(self.lengths[self.order[i % len(self.order)]])
        starts = np.zeros((1, n), bool)
        starts[0, 0] = True
        toks = markov_rows(self.table, starts, float(self.mix["follow"]),
                           rng(self.seed, 0x9A0, i))[0]
        lo = int(self.mix.get("min_token", 0))
        return np.clip(toks, lo, self.vocab - 1).astype(np.int32)

    def next(self) -> tuple[int, np.ndarray]:
        i = self.sent
        self.sent += 1
        return i, self.prompt(i)

    def stagger(self) -> int:
        """Ticks between two clients' first requests in the ramp, so that
        completions spread over a request's lifetime."""
        return max(1, math.ceil(self.output_len / max(1, self.clients)))
