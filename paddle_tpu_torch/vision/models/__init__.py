"""paddle.vision.models: the ResNet family and MobileNetV1-V3. The other
model files (VGG, GoogLeNet, ShuffleNetV2, DenseNet, SqueezeNet, AlexNet,
LeNet, InceptionV3) wait for a later slice (ROADMAP Queue A item 4b)."""
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .mobilenetv3 import MobileNetV3Large, MobileNetV3Small, mobilenet_v3_large, mobilenet_v3_small
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152, resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d, wide_resnet50_2,
                     wide_resnet101_2)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d", "wide_resnet50_2",
           "wide_resnet101_2", "MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2",
           "MobileNetV3Large", "MobileNetV3Small", "mobilenet_v3_large", "mobilenet_v3_small"]
