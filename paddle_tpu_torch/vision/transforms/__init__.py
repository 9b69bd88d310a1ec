"""paddle.vision.transforms: the functional resize the OCR pipeline crops
with. The other transforms wait for a later slice."""
from . import functional
from .functional import resize

__all__ = ["functional", "resize"]
