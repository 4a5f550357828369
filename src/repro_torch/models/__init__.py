"""Model zoo of the port: decoder-only transformers (dense / MoE / the VLM
backbone), Mamba-2 SSD, the RecurrentGemma hybrid and the Whisper
encoder-decoder — plain functions over stacked-layer param dicts, as in
``repro.models``."""
from . import layers, mamba2, recurrentgemma, transformer, whisper
from .layers import MoEConfig
from .mamba2 import Mamba2Config
from .recurrentgemma import RGConfig
from .transformer import TransformerConfig
from .whisper import WhisperConfig

__all__ = [
    "layers", "mamba2", "recurrentgemma", "transformer", "whisper",
    "MoEConfig", "Mamba2Config", "RGConfig", "TransformerConfig",
    "WhisperConfig",
]
