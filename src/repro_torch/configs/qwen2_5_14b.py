"""qwen2.5-14b [dense]: 48L d=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 —
GQA + QKV bias (the reference's configs/qwen2_5_14b.py)."""
import torch

from repro_torch.models import TransformerConfig, transformer
from .base import ArchBundle

ARCH_ID = "qwen2.5-14b"


def full_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1e6)
    return ArchBundle(ARCH_ID, "dense", cfg, transformer)


def smoke_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=80, n_heads=5,
        n_kv_heads=1, d_ff=160, vocab=256, qkv_bias=True,
        dtype=torch.float32)
    return ArchBundle(ARCH_ID, "dense", cfg, transformer)
