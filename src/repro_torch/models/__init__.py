"""Model zoo of the port: the dense GQA decoder so far (plain functions over
stacked-layer param dicts, as in ``repro.models``)."""
from . import layers, transformer
from .transformer import TransformerConfig

__all__ = ["layers", "transformer", "TransformerConfig"]
