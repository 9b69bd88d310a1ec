"""paddle.vision: the ResNet family (vision/models). The other models,
datasets and transforms wait for later slices."""
from . import models

__all__ = ["models"]
