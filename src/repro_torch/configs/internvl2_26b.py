"""internvl2-26b [vlm]: InternLM2 backbone 48L d=6144 48H (GQA kv=8)
d_ff=16384 vocab=92672 (the reference's configs/internvl2_26b.py).  The
InternViT frontend is a STUB: precomputed patch embeddings (B, 256, D)
prefix the text sequence."""
import torch

from repro_torch.models import TransformerConfig, transformer
from .base import ArchBundle

ARCH_ID = "internvl2-26b"


def full_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92672, vision_tokens=256, rope_theta=1e6)
    return ArchBundle(ARCH_ID, "vlm", cfg, transformer,
                      extras={"true_vocab": 92553})


def smoke_bundle() -> ArchBundle:
    cfg = TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, vision_tokens=8,
        dtype=torch.float32)
    return ArchBundle(ARCH_ID, "vlm", cfg, transformer)
