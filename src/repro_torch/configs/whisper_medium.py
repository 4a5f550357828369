"""whisper-medium [audio]: 24L (enc) + 24L (dec) d=1024 16H (MHA)
d_ff=4096 vocab=51968 — enc-dec; the conv frontend is a STUB (precomputed
frame embeddings) (the reference's configs/whisper_medium.py)."""
import torch

from repro_torch.models import WhisperConfig, whisper
from .base import ArchBundle

ARCH_ID = "whisper-medium"


def full_bundle() -> ArchBundle:
    cfg = WhisperConfig(name=ARCH_ID, n_layers=24, d_model=1024, n_heads=16,
                        d_ff=4096, vocab=51968, n_audio_ctx=1500,
                        max_text_ctx=32768)
    return ArchBundle(ARCH_ID, "audio", cfg, whisper,
                      extras={"true_vocab": 51865})


def smoke_bundle() -> ArchBundle:
    cfg = WhisperConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=64,
                        n_heads=4, d_ff=128, vocab=256, n_audio_ctx=32,
                        max_text_ctx=64, dtype=torch.float32)
    return ArchBundle(ARCH_ID, "audio", cfg, whisper)
