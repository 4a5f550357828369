"""Model zoo of the port: the GQA decoder with dense or top-k MoE MLPs
(plain functions over stacked-layer param dicts, as in ``repro.models``)."""
from . import layers, transformer
from .layers import MoEConfig
from .transformer import TransformerConfig

__all__ = ["layers", "transformer", "MoEConfig", "TransformerConfig"]
