"""Models of the ported slices: Llama (serving and training) and ERNIE
(MLM pretraining)."""
from . import ernie, llama
from .ernie import ErnieForMaskedLM, ErnieModel

__all__ = ["ernie", "llama", "ErnieForMaskedLM", "ErnieModel"]
