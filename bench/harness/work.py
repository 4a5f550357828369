"""The yardstick's frozen arithmetic: the card's peaks, each kernel's work
from its shapes, and a step's model flops.

Copied from the port's ``analysis.roofline`` (the H100 datasheet peaks)
and ``analysis.kernel_work`` (flops and bytes of the flash and paged
kernels), so a later change to the program cannot move the yardstick.
Work is what the layer's shapes need, whatever kernel computes it: each
input byte read once, each output byte written once, the attended (q, k)
pairs under the causal mask.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 80GB HBM3 (SXM) datasheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def attended_pairs(Sq: int, Sk: int, causal: bool = True,
                   shift: int = 0) -> int:
    """(q, k) pairs one head attends: q row i at position i + shift
    against keys 0 .. Sk - 1, k <= q when causal."""
    q = np.arange(Sq, dtype=np.int64) + shift
    hi = np.minimum(q + 1, Sk) if causal else np.full(Sq, Sk, np.int64)
    return int(np.maximum(hi, 0).sum())


def flash_fwd(B, H, Hkv, Sq, Sk, D, itemsize=2, causal=True):
    """(flops, bytes): QK^T and PV over the attended pairs (4 D a pair);
    q, k, v read and o written in the inputs' dtype, f32 lse written."""
    pairs = B * H * attended_pairs(Sq, Sk, causal)
    qn, kn = B * H * Sq * D, B * Hkv * Sk * D
    return 4 * D * pairs, itemsize * (2 * qn + 2 * kn) + 4 * B * H * Sq


def flash_bwd(B, H, Hkv, Sq, Sk, D, itemsize=2, causal=True):
    """(flops, bytes) of the backward, dq and dk/dv together: the products
    the gradients need (dO V^T, dS K, P^T dO, dS^T Q, and QK^T once, 10 D a
    pair); q, k, v, o, do in the inputs' dtype and the f32 lse read once,
    dq, dk, dv written in the inputs' dtype."""
    pairs = B * H * attended_pairs(Sq, Sk, causal)
    qn, kn = B * H * Sq * D, B * Hkv * Sk * D
    read = itemsize * (3 * qn + 2 * kn) + 4 * B * H * Sq
    write = itemsize * (qn + 2 * kn)
    return 10 * D * pairs, read + write


def paged_decode_bytes(live_tokens: int, n_rows: int, H: int, Hkv: int,
                       D: int, kv_itemsize: int = 2,
                       q_itemsize: int = 2) -> int:
    """Bytes one layer's paged decode needs: each attended token's K and V
    rows once, each row's q read and o written once."""
    return (2 * live_tokens * Hkv * D * kv_itemsize
            + 2 * q_itemsize * n_rows * H * D)


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_S)


# ---------------------------------------------------------------------------
# model flops (mfu)
# ---------------------------------------------------------------------------

def matmul_params(s: dict) -> tuple[int, int]:
    """(parameters a token multiplies in one layer: attention, router and
    its active experts or the dense MLP; the lm_head's), from the sizes of
    :func:`harness.spec.model_sizes`.  The embedding is a lookup."""
    D, H, Kv, Dh = s["d_model"], s["n_heads"], s["n_kv_heads"], s["head_dim"]
    attn = D * H * Dh * 2 + D * Kv * Dh * 2
    if s["n_experts"]:
        mlp = D * s["n_experts"] + 3 * s["top_k"] * D * s["d_ff"]
    else:
        mlp = 3 * D * s["d_ff"]
    return attn + mlp, D * s["vocab"]


def forward_flops(s: dict, tokens: int, attended: int) -> float:
    """Forward flops of ``tokens`` tokens that attend ``attended`` (q, k)
    pairs a head in all: 2 a parameter a token, 4 head_dim a pair a head a
    layer."""
    layer, head = matmul_params(s)
    L = s["n_layers"]
    return (2 * (L * layer + head) * tokens
            + 4 * s["head_dim"] * s["n_heads"] * L * attended)


def train_step_flops(s: dict, batch: int, seq: int) -> float:
    """Model flops of one training step, forward and backward (3x the
    forward), recompute not counted."""
    return 3 * forward_flops(s, batch * seq, batch * attended_pairs(seq, seq))
