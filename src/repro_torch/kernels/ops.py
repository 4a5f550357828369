"""Public wrappers around the hand-written CUDA kernels.

Counterpart of ``repro.kernels.ops`` for the kernels of the serving and
training paths: flash attention (forward, and the dq and dk/dv backward
kernels under autograd) and paged decode.  Each wrapper takes the reference
wrapper's layout, records its dispatch, and then

* on CUDA tensors launches its kernels (``kernels/csrc``) — or raises:
  nothing falls back to the plain version or to the CPU.  Each kernel's
  launcher adds one to its entry in :data:`LAUNCHES` where it launches,
  whichever entry point called it;
* on CPU tensors runs the plain PyTorch version of the same arithmetic
  (the path the parity tests take).

Block shapes are the kernels' own, fixed for sm_90a (64 x 64 for flash
forward and backward; one page per step for paged decode).  The
reference's tile search (``repro.core``) is not ported yet.
"""
from __future__ import annotations

import torch

from . import attention as _attention
from . import paged_attention as _paged_attention
from ._build import LAUNCHES


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _record_dispatch(kernel: str, **args) -> None:
    """Telemetry hook for kernel dispatch decisions (impl chosen, shapes,
    pruning ratio).  Counters land in the global registry unconditionally;
    the trace instant fires only when telemetry is enabled."""
    from repro_torch.obs import REGISTRY, get_telemetry
    REGISTRY.counter("kernel_dispatch", kernel=kernel,
                     impl=str(args.get("impl", "cuda")))
    if "pruning_ratio" in args:
        REGISTRY.gauge("kernel_pruning_ratio", args["pruning_ratio"],
                       kernel=kernel, sq=args.get("sq"), sk=args.get("sk"))
    t = get_telemetry()
    if t.enabled:
        t.instant("kernel_dispatch", cat="kernel", kernel=kernel, **args)


def _impl(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel for device {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q: (B, H, S, D), k/v: (B, Hkv, Sk, D) -> (B, H, S, D).

    When autograd wants a gradient of q, k or v, the call goes through
    :class:`attention.FlashAttention`: the forward kernel saves its lse and
    the backward runs the dq and dk/dv kernels.  Otherwise it is the
    forward-only launch, as on the serving path.  On CUDA the kernels read
    q/k/v through their strides, so the ``transpose(1, 2)`` views of
    (B, S, H, D) activations cost no copy, and the output keeps q's memory
    layout.  Fully masked k blocks are pruned from the schedule."""
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    impl = _impl(q)
    train = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    bq, bk = _attention.BLOCK_Q, _attention.BLOCK_K
    real, total = _attention.scheduled_block_counts(
        Sq, Sk, block_q=bq, block_k=bk, causal=causal, window=window)
    _record_dispatch("flash_attention", impl="train" if train else impl,
                     sq=Sq, sk=Sk, block_q=bq, block_k=bk,
                     scheduled_blocks=real, dense_blocks=total,
                     pruning_ratio=real / total if total else 1.0)
    if train:
        return _attention.flash_attention_train(q, k, v, causal=causal,
                                                window=window)
    if impl == "cuda":
        o, _ = _attention.flash_attention_fwd_cuda(q, k, v, causal=causal,
                                                   window=window)
        return o
    o, _ = _attention.flash_attention_fwd_plain(
        q.reshape(B * H, Sq, D), k.reshape(B * Hkv, Sk, D),
        v.reshape(B * Hkv, Sk, D), causal=causal, window=window,
        block_q=bq, block_k=bk)
    return o.reshape(B, H, Sq, D)


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor,
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Paged decode: q (B, H, D) one token; pools (P, page, Hkv, D) read in
    place; page_table (B, max_pages) physical page ids; lengths (B,) valid
    tokens (>= 1); optional int8-pool scales (P, page, Hkv).  Returns
    (B, H, D).  Unlike the reference wrapper, nothing is transposed or
    replicated: the kernel walks the engine's layout directly."""
    B, _, _ = q.shape
    P, page_size, _, _ = k_pages.shape
    quant = k_scale is not None
    impl = _impl(q)
    _record_dispatch("paged_flash_decode",
                     impl=impl if not quant else f"{impl}-int8",
                     batch=B, pages=P, page_size=page_size,
                     max_pages=int(page_table.shape[1]))
    if impl == "cuda":
        return _paged_attention.paged_flash_decode_cuda(
            q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)
    return _paged_attention.paged_flash_decode_plain(
        q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)
