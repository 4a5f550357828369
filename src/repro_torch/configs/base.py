"""Architecture bundles, the ring-attention and the flash-attention
policies.

Counterpart of ``repro.configs.base``.  A bundle wires a model family
(transformer — dense, MoE or the vision-prefix backbone — / mamba2 /
recurrentgemma / whisper) to the server and the trainer:

  * ``init_params(seed, device)``  — random weights drawn on the device
  * ``abstract_params()``          — the same tree on the meta device
  * ``forward(params, batch)``     — (logits, aux)
  * ``prefill`` / ``decode_step``  — dense-cache serving steps
  * ``init_paged_pool`` / ``paged_step`` — paged serving steps
  * ``input_specs(shape)``         — meta tensors for a named shape's step
  * ``step_kind(shape)``           — which step function the shape runs
  * ``supports(shape)``            — long_500k only for sub-quadratic archs

SHAPES (the reference's): train_4k (4096 x 256, train_step), prefill_32k
(32768 x 32, prefill), decode_32k (one token, 32k cache, batch 128),
long_500k (one token, 524288 context, batch 1; SSM/hybrid only).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import store_specs

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

META = torch.device("meta")


def tree_nbytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return 0 if tree is None else tree.numel() * tree.element_size()

# ---------------------------------------------------------------------------
# Context-parallel ring-attention policy
#
# Callers resolve a policy (explicit argument > REPRO_RING_ATTN env >
# default) instead of flag-flipping module state; the reference's modes,
# thresholds and precedence.
# ---------------------------------------------------------------------------

RING_MODES = ("auto", "ring", "replicated", "off")


@dataclasses.dataclass(frozen=True)
class RingAttnPolicy:
    """How ``models.layers.attention`` distributes long sequences over the
    ``model`` mesh axis.

    mode:
      * ``auto``       — the ring (``parallel.ring_attention``, memory-flat
        backward) for long sequences, the replicated-k/v path below
        ``seq_threshold`` (short sequences do not amortize the hops);
      * ``ring``       — always the ring when shapes divide;
      * ``replicated`` — always the replicated-k/v path;
      * ``off``        — neither.

    ``max_seq_per_device`` caps the ring shard: above it ``auto`` falls
    back to the replicated path."""
    mode: str = "auto"
    seq_threshold: int = 4096
    max_seq_per_device: int = 4096


DEFAULT_RING_POLICY = RingAttnPolicy()


def ring_attn_policy(mode_override: str | None = None) -> RingAttnPolicy:
    """Resolve the active ring policy.  Precedence: explicit
    ``mode_override`` (e.g. ``TransformerConfig.ring_attn``) >
    ``REPRO_RING_ATTN`` env var > ``DEFAULT_RING_POLICY``;
    ``REPRO_RING_ATTN_THRESHOLD`` / ``REPRO_RING_ATTN_MAX_SHARD`` tune the
    ``auto`` thresholds."""
    mode = (mode_override or os.environ.get("REPRO_RING_ATTN")
            or DEFAULT_RING_POLICY.mode)
    if mode not in RING_MODES:
        raise ValueError(f"ring-attention mode {mode!r} not in {RING_MODES}")
    thr = int(os.environ.get("REPRO_RING_ATTN_THRESHOLD",
                             DEFAULT_RING_POLICY.seq_threshold))
    cap = int(os.environ.get("REPRO_RING_ATTN_MAX_SHARD",
                             DEFAULT_RING_POLICY.max_seq_per_device))
    return RingAttnPolicy(mode=mode, seq_threshold=thr,
                          max_seq_per_device=cap)


def decide_ring(policy: RingAttnPolicy, *, seq_len: int,
                ring_size: int) -> str:
    """'ring', 'replicated' or 'off' for a global sequence of ``seq_len``
    on a ``ring_size``-wide model axis."""
    if policy.mode != "auto":
        return policy.mode
    if (seq_len >= policy.seq_threshold
            and seq_len // ring_size <= policy.max_seq_per_device):
        return "ring"
    return "replicated"


# ---------------------------------------------------------------------------
# Flash-attention policy (the hand-written flash kernel vs the plain paths)
#
# Callers resolve a policy (explicit argument > REPRO_FLASH_ATTN env >
# default) instead of flag-flipping module state.  The three mode names are
# the reference's; in this port ``pallas`` names the hand-written Hopper
# kernel (kernels/csrc/flash_fwd.cu), and ``xla`` the plain PyTorch paths.
# ---------------------------------------------------------------------------

FLASH_MODES = ("auto", "pallas", "xla")


@dataclasses.dataclass(frozen=True)
class FlashAttnPolicy:
    """Which attention engine ``models.layers.attention`` dispatches to.

    mode:
      * ``auto``   — the CUDA kernel for tensors on a CUDA device (or on
        the meta device, which stands for the card) and
        sequences at least ``min_seq`` long (below it the plain full-mask
        path is used, as in the reference); the plain paths on the CPU.
      * ``pallas`` — always the kernel (its plain version on the CPU).
      * ``xla``    — never; the plain PyTorch paths.
    """
    mode: str = "auto"
    min_seq: int = 1024


DEFAULT_FLASH_POLICY = FlashAttnPolicy()


def flash_attn_policy(mode_override: str | None = None) -> FlashAttnPolicy:
    """Resolve the active flash-attention policy.  Precedence: explicit
    ``mode_override`` (e.g. ``TransformerConfig.attn_impl``) >
    ``REPRO_FLASH_ATTN`` env var > default; ``REPRO_FLASH_ATTN_MIN_SEQ``
    tunes the ``auto`` threshold."""
    mode = (mode_override or os.environ.get("REPRO_FLASH_ATTN")
            or DEFAULT_FLASH_POLICY.mode)
    if mode not in FLASH_MODES:
        raise ValueError(f"flash-attention mode {mode!r} not in "
                         f"{FLASH_MODES}")
    ms = int(os.environ.get("REPRO_FLASH_ATTN_MIN_SEQ",
                            DEFAULT_FLASH_POLICY.min_seq))
    return FlashAttnPolicy(mode=mode, min_seq=ms)


def decide_flash(policy: FlashAttnPolicy, *, seq_len: int, kv_len: int,
                 on_cuda: bool) -> str:
    """'pallas' (the hand-written kernel) or 'xla' for one attention call.
    ``auto`` requires the tensors to be on a CUDA device (``on_cuda``:
    ``device.card_like``, so meta tensors too) and a sequence
    long enough to amortize the launch (the reference's rule, with the
    TPU replaced by the CUDA card)."""
    if policy.mode != "auto":
        return policy.mode
    if on_cuda and max(seq_len, kv_len) >= policy.min_seq:
        return "pallas"
    return "xla"


@dataclasses.dataclass
class ArchBundle:
    arch_id: str
    kind: str                   # dense | moe | vlm | ssm | audio | hybrid
    cfg: Any
    family: Any                 # model module
    sub_quadratic: bool = False
    kv_dtype_decode: Any = None  # e.g. torch.int8 for big dense decode
    extras: dict = dataclasses.field(default_factory=dict)

    # -- params ------------------------------------------------------------
    def init_params(self, seed: int = 0, device=None) -> dict:
        """Random weights from ``seed``, drawn on ``device`` (default: the
        CUDA card; raises when there is none — pass ``device='cpu'``)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return self.family.init_params(self.cfg, gen, dev)

    def abstract_params(self) -> dict:
        """The parameter tree on the meta device: every leaf's shape and
        dtype, no storage (the reference's ``jax.eval_shape`` of
        ``init_params``)."""
        return self.family.init_params(self.cfg, None, META)

    def param_count(self) -> int:
        return self.cfg.param_count()

    def active_param_count(self) -> int:
        if hasattr(self.cfg, "active_param_count"):
            return self.cfg.active_param_count()
        return self.param_count()

    # -- steps -------------------------------------------------------------
    def zero_extras(self, batch: int, dtype: torch.dtype, device) -> dict:
        """The stub frontends' zero inputs for ``batch`` rows, of ``dtype``
        on ``device``: ``frames`` (batch, n_audio_ctx, d_model) for the
        audio kind, ``vision`` (batch, vision_tokens, d_model) for the vlm
        kind, none otherwise."""
        cfg = self.cfg
        if self.kind == "audio":
            name, n = "frames", cfg.n_audio_ctx
        elif self.kind == "vlm":
            name, n = "vision", cfg.vision_tokens
        else:
            return {}
        return {name: torch.zeros((batch, n, cfg.d_model), dtype=dtype,
                                  device=device)}

    def forward(self, params, batch):
        if self.kind == "audio":
            return self.family.forward(self.cfg, params, batch["tokens"],
                                       batch["frames"])
        if self.kind == "vlm":
            return self.family.forward(self.cfg, params, batch["tokens"],
                                       vision_embeds=batch["vision"])
        return self.family.forward(self.cfg, params, batch["tokens"])

    def init_cache(self, batch: int, max_len: int, kv_dtype=None,
                   device=None):
        return self.family.init_cache(self.cfg, batch, max_len,
                                      kv_dtype=kv_dtype, device=device)

    def prefill(self, params, tokens, cache, batch_extras=None,
                true_lengths=None):
        if true_lengths is not None and not self.prefill_supports_true_lengths:
            raise ValueError(
                f"{self.arch_id}: family does not support bucketed "
                "(true_lengths) prefill")
        extras = batch_extras or {}
        if self.kind == "audio":
            return self.family.prefill(self.cfg, params, tokens, cache,
                                       extras["frames"])
        if self.kind == "vlm":
            kw = {}
            if true_lengths is not None:
                # the vision prefix is prepended inside prefill, so true
                # sequence lengths shift by the (fixed) prefix size
                vis = extras.get("vision")
                off = vis.shape[1] if vis is not None else 0
                kw["true_lengths"] = true_lengths + off
            return self.family.prefill(self.cfg, params, tokens, cache,
                                       vision_embeds=extras.get("vision"),
                                       **kw)
        kw = {} if true_lengths is None else {"true_lengths": true_lengths}
        return self.family.prefill(self.cfg, params, tokens, cache, **kw)

    def decode_step(self, params, tokens, cache):
        return self.family.decode_step(self.cfg, params, tokens, cache)

    # -- placed state --------------------------------------------------------
    @property
    def has_placed_body(self) -> bool:
        """Whether the family's entry points take a state placed by
        ``parallel.sharding.shard_tree`` (its module's ``placed``)."""
        return callable(getattr(self.family, "placed", None))

    def require_placed_body(self) -> None:
        """Raise ValueError, naming the kind, unless the family has a
        placed body: a placed state never reaches a body that cannot take
        it, and nothing falls back to the whole state unasked."""
        if not self.has_placed_body:
            raise ValueError(
                f"{self.arch_id}: kind {self.kind!r} has no tensor-parallel "
                f"body on a placed state (its module has no placed()); "
                f"place=False keeps the whole state on every rank")

    def store_specs(self, store: dict, mesh) -> dict:
        """The specs a cache or pool of this family is placed by on a
        placed state (``parallel.sharding.store_specs``)."""
        return store_specs(self.kind, store, mesh, self.cfg)

    # -- serving capabilities ---------------------------------------------
    @property
    def prefill_supports_true_lengths(self) -> bool:
        """Whether prefill accepts length-bucketed padded prompts (KV
        caches with per-position writes; SSM states do not qualify)."""
        return bool(getattr(self.family, "PREFILL_TRUE_LENGTHS", False)) \
            and self.kind != "audio"

    @property
    def supports_paged_kv(self) -> bool:
        # vlm excluded: the vision prefix enters through dense prefill's
        # embedding concat; the paged chunked-prefill path is token-only.
        return bool(getattr(self.family, "SUPPORTS_PAGED_KV", False)) \
            and self.kind != "vlm"

    def init_paged_pool(self, num_pages: int, page_size: int, kv_dtype=None,
                        device=None):
        return self.family.init_paged_pool(self.cfg, num_pages, page_size,
                                           kv_dtype=kv_dtype, device=device)

    def paged_step(self, params, tokens, pool, page_table, lengths, counts):
        return self.family.paged_step(self.cfg, params, tokens, pool,
                                      page_table, lengths, counts)

    def cache_batch_axes(self, cache) -> dict:
        """Batch-axis index for every cache entry (pooled slot writes).
        Families declare ``CACHE_BATCH_AXES``; unknown keys fall back to
        axis 0 for 1-D entries, else axis 1."""
        declared = getattr(self.family, "CACHE_BATCH_AXES", {})
        return {k: declared.get(k, 0 if v.dim() == 1 else 1)
                for k, v in cache.items()}

    def min_hbm_bytes(self, shape_name: str) -> int:
        """Theoretical HBM traffic floor for one step of this shape.

        train:   params read fwd+bwd + grads w+r + Adam mu/nu r+w (f32) +
                 layer-boundary activations w+r (bf16)
        decode:  full params read once + KV cache read (+ small writes)
        prefill: params read + activations written + cache written
        """
        sh = SHAPES[shape_name]
        S, B = sh["seq_len"], sh["global_batch"]
        kind = sh["kind"]
        n = self.param_count()
        D = self.cfg.d_model
        L = getattr(self.cfg, "n_layers", 1)
        if kind == "train":
            act = 2 * 2 * L * B * S * D           # save+read, bf16
            return int(3 * 2 * n + (4 + 16) * n + act)
        # serving floors
        cache_bytes = tree_nbytes(self.init_cache(B, S, device=META))
        if kind == "decode":
            return int(2 * n + cache_bytes)
        act = 2 * B * S * D * L
        return int(2 * n + cache_bytes + act)

    # -- shapes ------------------------------------------------------------
    def supports(self, shape_name: str) -> tuple[bool, str]:
        if shape_name == "long_500k" and not self.sub_quadratic:
            return False, ("full quadratic attention: 512k decode cache "
                           "infeasible; run on SSM/hybrid archs only "
                           "(see DESIGN.md §Arch-applicability)")
        return True, ""

    def step_kind(self, shape_name: str) -> str:
        return SHAPES[shape_name]["kind"]

    def input_specs(self, shape_name: str) -> dict:
        """Meta tensors standing for every input of the shape's step
        function (the reference's ShapeDtypeStruct stand-ins): tokens and
        labels (train), the vision prefix or audio frames of a vlm or audio
        arch, and the cache of a serving step."""
        sh = SHAPES[shape_name]
        S, B = sh["seq_len"], sh["global_batch"]
        kind = sh["kind"]
        D = self.cfg.d_model

        def spec(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device=META)

        if kind == "train":
            if self.kind == "vlm":
                P = self.cfg.vision_tokens
                return {"tokens": spec((B, S - P)),
                        "labels": spec((B, S - P)),
                        "vision": spec((B, P, D), self.cfg.dtype)}
            if self.kind == "audio":
                return {"tokens": spec((B, S)), "labels": spec((B, S)),
                        "frames": spec((B, self.cfg.n_audio_ctx, D),
                                       self.cfg.dtype)}
            return {"tokens": spec((B, S)), "labels": spec((B, S))}

        if kind == "prefill":
            specs = {"tokens": spec((B, S))}
            if self.kind == "vlm":
                P = self.cfg.vision_tokens
                specs["tokens"] = spec((B, S - P))
                specs["vision"] = spec((B, P, D), self.cfg.dtype)
            if self.kind == "audio":
                specs["frames"] = spec((B, self.cfg.n_audio_ctx, D),
                                       self.cfg.dtype)
            specs["cache"] = self.init_cache(B, S, device=META)
            return specs

        # decode: one token against a cache of S
        kv_dt = self.kv_dtype_decode if shape_name == "decode_32k" else None
        return {"tokens": spec((B, 1)),
                "cache": self.init_cache(B, S, kv_dtype=kv_dt,
                                         device=META)}
