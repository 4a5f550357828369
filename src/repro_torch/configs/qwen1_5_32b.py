"""qwen1.5-32b [dense]: 64L d=5120 40H (MHA kv=40) d_ff=27392 vocab=152064 —
QKV bias.  Decode caches quantize to int8 (the reference's
configs/qwen1_5_32b.py)."""
import torch

from repro_torch.models import TransformerConfig, transformer
from .base import ArchBundle

ARCH_ID = "qwen1.5-32b"


def full_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID, n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27392, vocab=152064, qkv_bias=True, rope_theta=1e6)
    return ArchBundle(ARCH_ID, "dense", cfg, transformer,
                      kv_dtype_decode=torch.int8)


def smoke_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=192, vocab=256, qkv_bias=True,
        dtype=torch.float32)
    return ArchBundle(ARCH_ID, "dense", cfg, transformer,
                      kv_dtype_decode=torch.int8)
