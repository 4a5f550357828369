"""Public wrappers around the hand-written CUDA kernels.

Counterpart of ``repro.kernels.ops``: the serving and training paths'
flash attention (forward, and the dq and dk/dv backward kernels under
autograd) and paged decode, and the paper's workloads — ``matmul``,
``conv2d``, ``correlation`` and dense ``flash_decode``.  Each wrapper takes
the reference wrapper's signature and layouts, records its dispatch, and
then

* on CUDA tensors launches its kernels (``kernels/csrc``) — or raises:
  nothing falls back to the plain version or to the CPU.  Each kernel's
  launcher adds one to its entry in :data:`LAUNCHES` where it launches,
  whichever entry point called it;
* on meta tensors takes each kernel's meta route: the launcher's checks
  and its outputs' shapes and dtypes, and no launch (the dry run and the
  op cost counter);
* on CPU tensors runs the plain PyTorch version of the same arithmetic
  (the path the parity tests take).

Under an op cost counter (``analysis.op_cost``) each wrapper reports its
kernel's work (``analysis.kernel_work``) on every device, and none of the
aten ops inside it counts, so a call counts the same on the card, the CPU
and the meta device.

``matmul`` takes one of three routes (``kernels.matmul.matmul_route``:
the ``wgmma`` kernel for bf16 with M > 1, the split-K GEMV for bf16 with
M = 1, the CUDA-core kernel for f32 or operands TMA cannot read), and the
tiled routes' blocks come from the paper's tile search re-targeted to one
H100 CTA (``repro_torch.core.cuda_bridge.matmul_block_shapes``); the flash
forward takes a ``wgmma`` kernel for bf16 (128 x 128 blocks at head_dim 64
or 128, 128 x 64 at 256) and the CUDA-core one (64 x 64) for f32
(``attention.flash_fwd_route``), and a block a caller names must be the
route's; ``conv2d`` takes the ``wgmma``
implicit GEMM for bf16, its tile and K split from
``cuda_bridge.conv2d_plan``, and the CUDA-core kernel for f32
(``conv2d.conv2d_route``); ``correlation`` takes the ``wgmma`` row-pair
kernel for bf16, tiled by ``cuda_bridge.correlation_plan``, and the
CUDA-core one, with the reference's ``block_y`` and its clamp, for f32
(``correlation.correlation_route``); dense decode splits the history into
``block_k``-token splits combined by their lse.  The flash backward
kernels keep their route's blocks and paged decode one page a step.  The
ragged edges are masked in the kernels: no wrapper pads by a copy.
"""
from __future__ import annotations

import torch

from ..core.cuda_bridge import (conv2d_blocks_built, conv2d_plan,
                                correlation_plan, gemv_plan,
                                matmul_block_shapes)
from . import attention as _attention
from . import conv2d as _conv2d
from . import correlation as _correlation
from . import matmul as _matmul
from . import paged_attention as _paged_attention
from ..analysis import kernel_work
from ..analysis.op_cost import kernel as kernel_cost
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
    """"cuda" (the kernels), "meta" (their meta routes: the launchers'
    checks and outputs, no launch) or "plain" (the CPU's plain versions);
    any other device raises."""
    if x.is_cuda:
        return "cuda"
    if x.is_meta:
        return "meta"
    if x.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel for device {x.device}")


def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _live_tokens(lengths: torch.Tensor, cap: int) -> int:
    """Tokens a decode call attends: the lengths' sum, each at most
    ``cap`` (a host read, made only under a cost counter); on the meta
    device, which has no lengths, every row at ``cap``."""
    if lengths.is_meta:
        return cap * lengths.shape[0]
    return int(lengths.long().clamp(max=cap).sum())


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int | None = None,
           block_n: int | None = None, block_k: int | None = None
           ) -> torch.Tensor:
    """VectorMesh-tiled matmul: (M, K) @ (K, N) -> (M, N) in a's dtype.

    The route (``matmul``, ``matmul_gemv`` or ``matmul_simt``) follows from
    the operands and from whether a block is given
    (``kernels.matmul.matmul_route``).  The GEMV takes no tile (its K split
    comes from ``cuda_bridge.gemv_plan``), so it runs only when no block is
    given; a block given for bf16 M = 1 picks the tiled wgmma route, as a
    tile is honoured on every other shape.  Blocks not given come from the
    H100 tile search, and on CUDA a tile the route's kernel is not built
    for raises."""
    M, K = a.shape
    _, N = b.shape
    with kernel_cost(lambda: kernel_work.matmul(
            M, N, K, itemsize=a.element_size(), dtype=_dt(a))):
        return _matmul_call(a, b, block_m, block_n, block_k)


def _matmul_call(a, b, block_m, block_n, block_k) -> torch.Tensor:
    M, K = a.shape
    _, N = b.shape
    route = _matmul.matmul_route(
        a, b, tiled=any(x is not None for x in (block_m, block_n, block_k)))
    impl = _impl(a)
    if route == "matmul_gemv":
        splits, kchunk = gemv_plan(M, N, K)
        _record_dispatch("matmul", impl=impl, route=route, M=M, N=N, K=K,
                         splits=splits, kchunk=kchunk)
        if impl != "plain":
            return _matmul.matmul_gemv_cuda(a, b)
        return _matmul.matmul_gemv_plain(a, b)
    if block_m is None or block_n is None or block_k is None:
        bm, bn, bk = matmul_block_shapes(
            max(M, 8) if route == "matmul_simt" else M, N, K, route=route)
        block_m = block_m or bm
        block_n = block_n or bn
        block_k = block_k or bk
    _record_dispatch("matmul", impl=impl, route=route, M=M, N=N, K=K,
                     block_m=block_m, block_n=block_n, block_k=block_k)
    if impl != "plain":
        launch = (_matmul.matmul_cuda if route == "matmul"
                  else _matmul.matmul_simt_cuda)
        return launch(a, b, block_m=block_m, block_n=block_n,
                      block_k=block_k)
    return _matmul.matmul_plain(a, b, block_k=block_k)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           dilation: int = 1, block_oh: int | None = None,
           block_co: int | None = None) -> torch.Tensor:
    """NHWC x HWIO conv, VALID padding (pad x yourself for SAME).

    The route (``conv2d`` for bf16, ``conv2d_simt`` for f32 or operands
    TMA cannot read) follows from the operands
    (``kernels.conv2d.conv2d_route``).  On the wgmma route the tile and K
    split come from ``cuda_bridge.conv2d_plan``, which keeps the blocks
    given and raises, on the card, for blocks the kernel is not built for;
    the CUDA-core route takes the reference's defaults (8, 128) and clamp."""
    N, IH, IW, CI = x.shape
    KH, KW, _, CO = w.shape
    OH, OW = _conv2d.out_hw(IH, IW, KH, KW, stride, dilation)
    with kernel_cost(lambda: kernel_work.conv2d(
            N, IH, IW, CI, KH, KW, CO, OH, OW, itemsize=x.element_size(),
            dtype=_dt(x))):
        return _conv2d_call(x, w, stride, dilation, block_oh, block_co,
                            OH, OW)


def _conv2d_call(x, w, stride, dilation, block_oh, block_co, OH,
                 OW) -> torch.Tensor:
    N, _, _, CI = x.shape
    KH, KW, _, CO = w.shape
    impl = _impl(x)
    route = _conv2d.conv2d_route(x, w)
    if route == "conv2d" and (impl != "plain" or
                              conv2d_blocks_built(block_oh, block_co)):
        plan = conv2d_plan(N, OH, OW, CI, CO, KH, KW, stride=stride,
                           block_oh=block_oh, block_co=block_co)
        _record_dispatch("conv2d", impl=impl, route=route, oh=OH, ow=OW,
                         ci=CI, co=CO, block_oh=plan.block_oh,
                         block_ow=plan.block_ow, block_co=plan.block_co,
                         splits=plan.splits, ctas=plan.ctas)
        if impl != "plain":
            return _conv2d.conv2d_cuda(
                x, w, stride=stride, dilation=dilation,
                block_oh=plan.block_oh, block_ow=plan.block_ow,
                block_co=plan.block_co, splits=plan.splits)
    else:
        block_oh = min(block_oh or 8, OH)
        block_co = min(block_co or 128, CO)
        _record_dispatch("conv2d", impl=impl, route=route, oh=OH, ow=OW,
                         ci=CI, co=CO, block_oh=block_oh, block_co=block_co)
        if impl != "plain":
            return _conv2d.conv2d_simt_cuda(x, w, stride=stride,
                                            dilation=dilation,
                                            block_oh=block_oh,
                                            block_co=block_co)
    return _conv2d.conv2d_plain(x, w, stride=stride, dilation=dilation)


def correlation(i1: torch.Tensor, i2: torch.Tensor, *, radius: int,
                block_y: int = 8) -> torch.Tensor:
    """FlowNet correlation (Eq. 3): (H, W, C) x2 -> (H, W, D, D), D = 2R+1,
    indexed [dy, dx] in the last two axes.

    The route (``correlation`` for bf16 with C % 8 == 0, ``correlation_simt``
    for f32 or other C) follows from the operands
    (``kernels.correlation.correlation_route``).  The wgmma route is tiled
    by ``cuda_bridge.correlation_plan``; the CUDA-core route takes the
    reference's ``block_y`` and its clamp.  On the CPU both routes run
    ``correlation_plain``."""
    H, W, C = i1.shape
    with kernel_cost(lambda: kernel_work.correlation(
            H, W, C, radius, itemsize=i1.element_size(), dtype=_dt(i1))):
        return _correlation_call(i1, i2, radius, block_y)


def _correlation_call(i1, i2, radius, block_y) -> torch.Tensor:
    H, W, C = i1.shape
    impl = _impl(i1)
    route = _correlation.correlation_route(i1, i2, radius)
    if route == "correlation":
        plan = correlation_plan(H, W, C, radius)
        _record_dispatch("correlation", impl=impl, route=route, h=H, w=W,
                         c=C, radius=radius, rows=plan.rows,
                         dy_group=plan.dy_group, block_n=plan.block_n,
                         stages=plan.stages, ctas=plan.ctas)
        if impl != "plain":
            return _correlation.correlation_cuda(i1, i2, radius=radius,
                                                 plan=plan)
    else:
        block_y = min(block_y, H)
        _record_dispatch("correlation", impl=impl, route=route, h=H, w=W,
                         c=C, radius=radius, block_y=block_y)
        if impl != "plain":
            return _correlation.correlation_simt_cuda(i1, i2, radius=radius,
                                                      block_y=block_y)
    return _correlation.correlation_plain(i1, i2, radius=radius)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 block_k: int = 512) -> torch.Tensor:
    """q: (B, H, D) one token; caches: (B, Hkv, S, D), read in place;
    lengths: (B,) int32.  Returns (B, H, D).  The history is cut into
    splits of ``block_k`` cached tokens (after the reference's clamp), one
    CTA each on the card, combined by their lse."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    block_k = min(block_k, S)
    impl = _impl(q)
    _record_dispatch("flash_decode", impl=impl, batch=B, s=S,
                     block_k=block_k,
                     splits=_attention.decode_splits(S, block_k))
    with kernel_cost(lambda: kernel_work.flash_decode(
            B, H, Hkv, D, live_tokens=_live_tokens(lengths, S),
            itemsize=q.element_size(), dtype=_dt(q))):
        if impl != "plain":
            return _attention.flash_decode_cuda(q, k_cache, v_cache,
                                                lengths, block_k=block_k)
        return _attention.flash_decode_plain(q, k_cache, v_cache, lengths,
                                             block_k=block_k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    block_q: int | None = None, block_k: int | None = None,
                    trainable: bool = True, prune: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, S, D), k/v: (B, Hkv, Sk, D) -> (B, H, S, D); q's rows sit
    at positions ``q_offset`` on, k's at 0 on (a q shard against the whole
    k/v).

    The forward kernel's route (a wgmma kernel or the CUDA-core one) and
    its blocks follow from the inputs (``attention.flash_fwd_route``,
    ``attention.flash_fwd_blocks``).  On the card a ``block_q`` /
    ``block_k`` given must be the route's, or the call raises naming the
    route; the plain version on the CPU runs any blocks.  When
    ``trainable`` and autograd wants a gradient of q, k or v, the call goes
    through :class:`attention.FlashAttention`: the forward kernel saves its
    lse and the backward runs the dq and dk/dv kernels.  Otherwise it is
    the forward-only launch (under ``torch.no_grad()``), as on the serving
    path.  On CUDA the kernels read q/k/v through their strides, so the
    ``transpose(1, 2)`` views of (B, S, H, D) activations cost no copy, and
    the output keeps q's memory layout.  Fully masked k blocks are pruned
    from the schedule; ``prune=False`` walks the dense grid, whose extra
    blocks the kernels mask to exactly 0."""
    Sq, Sk = q.shape[2], k.shape[2]
    impl = _impl(q)
    train = trainable and torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    route = _attention.flash_fwd_route(q, k, v)
    rbq, rbk = _attention.flash_fwd_blocks(route)
    bq, bk = block_q or rbq, block_k or rbk
    if impl != "plain" and (bq, bk) != (rbq, rbk):
        raise ValueError(f"flash_attention: blocks (block_q {bq}, block_k "
                         f"{bk}) are not the ones route {route} is built "
                         f"for ({rbq}, {rbk})")
    real, total = _attention.scheduled_block_counts(
        Sq, Sk, block_q=bq, block_k=bk, causal=causal, window=window,
        q_offset=q_offset)
    if not prune:
        real = total                      # dense grid: nothing skipped
    # impl names what runs (the kernels or their plain versions), on the
    # training path too; ``train`` says whether the backward pair follows
    _record_dispatch("flash_attention",
                     impl=impl if trainable else f"{impl}-fwd", train=train,
                     route=route, sq=Sq, sk=Sk, block_q=bq, block_k=bk,
                     scheduled_blocks=real, dense_blocks=total,
                     pruning_ratio=real / total if total else 1.0)
    if train:
        return _attention.flash_attention_train(
            q, k, v, causal=causal, window=window, prune=prune,
            blocks=None if impl != "plain" else (bq, bk), q_offset=q_offset)
    with torch.no_grad(), kernel_cost(lambda: kernel_work.flash_fwd_of(
            q, k, causal=causal, window=window, q_offset=q_offset)):
        o, _ = _attention.flash_fwd_any(q, k, v, causal=causal,
                                        window=window, prune=prune,
                                        blocks=(bq, bk), q_offset=q_offset)
    return o


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor,
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Paged decode: q (B, H, D) one token; pools (P, page, Hkv, D) read in
    place; page_table (B, max_pages) physical page ids; lengths (B,) valid
    tokens (>= 1); optional int8-pool scales (P, page, Hkv).  Returns
    (B, H, D).  Unlike the reference wrapper, nothing is transposed or
    replicated: the kernel walks the engine's layout directly, its history
    split by ``paged_attention.paged_decode_plan`` (shapes only, so no
    host sync), and the CPU's plain version takes the same split."""
    B, _, _ = q.shape
    P, page_size, Hkv, _ = k_pages.shape
    MP = int(page_table.shape[1])
    quant = k_scale is not None
    impl = _impl(q)
    pps, nsplit = _paged_attention.paged_decode_plan(B, Hkv, MP, page_size)
    _record_dispatch("paged_flash_decode",
                     impl=impl if not quant else f"{impl}-int8",
                     batch=B, pages=P, page_size=page_size, max_pages=MP,
                     pages_per_split=pps, splits=nsplit)
    fn = (_paged_attention.paged_flash_decode_cuda if impl != "plain" else
          _paged_attention.paged_flash_decode_plain)
    with kernel_cost(lambda: kernel_work.paged_decode(
            B, q.shape[1], Hkv, q.shape[2],
            live_tokens=_live_tokens(lengths, MP * page_size),
            max_pages=MP, kv_itemsize=k_pages.element_size(),
            q_itemsize=q.element_size(), quant=quant)):
        return fn(q, k_pages, v_pages, page_table, lengths, k_scale,
                  v_scale, pages_per_split=pps)
