"""paddle.vision: the ResNet family (vision/models), box ops with nms
(vision/ops) and the host-side resize (vision/transforms). The other
models and datasets wait for later slices."""
from . import models, ops, transforms

__all__ = ["models", "ops", "transforms"]
