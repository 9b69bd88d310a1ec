"""paddle.vision: the ResNet and MobileNetV1-V3 families (vision/models),
the synthetic and folder datasets (vision/datasets), the host-side
transforms (vision/transforms) and box ops with nms and deform_conv2d
(vision/ops). The other models, the rest of vision/ops and the image
backend registry wait for a later slice (ROADMAP Queue A item 4b)."""
from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms"]
