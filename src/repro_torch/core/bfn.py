"""Butterfly-network conflict-free banked access (paper §II-C, MERIT [23]).

A TEU's input buffer is a 2^X-banked SRAM (X=5 -> 32 banks) feeding 2^X PEs
through a butterfly network. Lin et al. [23] show that if the address of PE N
can be written

    A_N = A_0 + sum_{i=0}^{X-1} 2^i * o_i * b_i      (o_i odd, b_i = i-th bit of N)

(the paper prints ``2^X o_i b_i``, a typo: with 2^X every term is bank-
aligned and all PEs hit bank A_0 mod 2^X — the MERIT condition is per-bit
weights 2^i with odd multipliers, which makes N -> A_N mod 2^X a bijection)

... then the butterfly can route all 2^X requests in one cycle. Two things must
hold for single-cycle service:
  (1) bank-conflict freedom: the bank index (A_N mod 2^X) is a *permutation*
      of the PEs, and
  (2) butterfly routability: the permutation is realizable by a 2^X butterfly.

The MERIT form guarantees both. This module provides an executable model:
  * ``merit_addresses``   — generate the guaranteed-good pattern;
  * ``is_conflict_free``  — check (1) for an arbitrary address vector;
  * ``butterfly_routable``— check (2) by actually routing the network;
  * ``pad_stride``        — the paper's padding fix: bump an even stride to the
      next odd one so strided access becomes conflict-free.

On the H100 the analogous structural constraints are the 32 shared-memory
banks and the alignment of the tiles a kernel is built for; see
``cuda_bridge``.  We keep this
model because it is a paper contribution and is property-tested in
``tests/test_bfn.py``.
"""
from __future__ import annotations

from typing import Sequence


def merit_addresses(base: int, odd_coeffs: Sequence[int], X: int) -> list[int]:
    """A_N = base + sum_i 2^i * o_i * b_i for N in [0, 2^X)."""
    if len(odd_coeffs) != X:
        raise ValueError(f"need {X} coefficients, got {len(odd_coeffs)}")
    for o in odd_coeffs:
        if o % 2 == 0:
            raise ValueError(f"coefficient {o} is even; MERIT requires odd")
    n = 1 << X
    out = []
    for N in range(n):
        a = base
        for i in range(X):
            if (N >> i) & 1:
                a += (1 << i) * odd_coeffs[i]
        out.append(a)
    return out


def strided_addresses(base: int, stride: int, X: int) -> list[int]:
    """The common pattern: PE N reads base + N*stride."""
    return [base + N * stride for N in range(1 << X)]


def bank_of(addr: int, X: int) -> int:
    return addr % (1 << X)


def is_conflict_free(addrs: Sequence[int], X: int) -> bool:
    """(1): all 2^X requests land in distinct banks."""
    banks = [bank_of(a, X) for a in addrs]
    return len(set(banks)) == len(addrs) == (1 << X)


def butterfly_routable(perm: Sequence[int], X: int) -> bool:
    """(2): can a 2^X butterfly realize PE N -> output perm[N]?

    A (single) butterfly network routes exactly the permutations where, at
    stage i (i = 0..X-1), each 2x2 switch is set consistently. We route
    greedily per stage: stage i partners differ in bit i of the *input* index;
    the switch must send one to the '0' side and one to the '1' side of bit i
    of the destination. Conflict (both partners need the same side) => not
    routable. This is the standard butterfly routing condition.
    """
    n = 1 << X
    if sorted(perm) != list(range(n)):
        return False
    cur = list(range(n))  # cur[pos] = packet originally from PE cur[pos]
    for stage in range(X):
        bit = 1 << stage
        nxt = [-1] * n
        for lo in range(n):
            if lo & bit:
                continue
            hi = lo | bit
            a, b = cur[lo], cur[hi]  # packets at the two switch inputs
            da, db = perm[a] & bit, perm[b] & bit
            if da == db:
                return False  # both packets want the same output port
            if da == 0:
                nxt[lo], nxt[hi] = a, b
            else:
                nxt[lo], nxt[hi] = b, a
        cur = nxt
    return all(cur[pos] is not None for pos in range(n)) and all(
        (perm[cur[pos]] == pos) for pos in range(n))


def serves_in_one_cycle(addrs: Sequence[int], X: int) -> bool:
    """Full condition: conflict-free banks AND butterfly-routable permutation."""
    if not is_conflict_free(addrs, X):
        return False
    # PE N needs the data in bank bank_of(addrs[N]); the network must route
    # bank b's read port to every PE requesting bank b.
    perm = [bank_of(a, X) for a in addrs]
    return butterfly_routable(perm, X)


def pad_stride(stride: int) -> int:
    """Paper's padding fix: strided patterns with an ODD stride are MERIT-form.

    base + N*stride has bank pattern N*stride mod 2^X, which is a permutation
    iff stride is odd. Padding each row of a 2D buffer by one element turns an
    even row-stride into an odd one.
    """
    return stride if stride % 2 == 1 else stride + 1


def xor_shuffle(addrs: Sequence[int], key: int, X: int) -> list[int]:
    """Bank-XOR shuffling [25]: remap bank = bank ^ (addr-dependent key).

    Used with pad_stride to make 2D tile accesses conflict-free; preserves
    the data, permutes the banks.
    """
    n = 1 << X
    return [(a - bank_of(a, X)) + (bank_of(a, X) ^ (key % n)) for a in addrs]
