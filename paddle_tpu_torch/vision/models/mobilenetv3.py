"""MobileNetV3 Small / Large (counterpart of
paddle_tpu/vision/models/mobilenetv3.py; reference
python/paddle/vision/models/mobilenetv3.py). Inverted residuals with
squeeze-excitation and hardswish, per the paper's stage tables; the JAX
package's attribute names and module order."""
from __future__ import annotations

from ... import nn
from ...ops.manipulation import flatten


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _SE(nn.Layer):
    def __init__(self, c, reduction=4):
        super().__init__()
        squeeze = _make_divisible(c // reduction)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(c, squeeze, 1)
        self.fc2 = nn.Conv2D(squeeze, c, 1)

    def forward(self, x):
        s = self.pool(x)
        s = nn.functional.relu(self.fc1(s))
        s = nn.functional.hardsigmoid(self.fc2(s))
        return x * s


def _act(name):
    return nn.Hardswish() if name == "HS" else nn.ReLU()


class _ConvBNAct(nn.Layer):
    def __init__(self, c_in, c_out, k, stride=1, groups=1, act="RE"):
        super().__init__()
        self.conv = nn.Conv2D(c_in, c_out, k, stride=stride,
                              padding=(k - 1) // 2, groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(c_out)
        self.act = _act(act) if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class _InvertedResidual(nn.Layer):
    def __init__(self, c_in, exp, c_out, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if exp != c_in:
            layers.append(_ConvBNAct(c_in, exp, 1, act=act))
        layers.append(_ConvBNAct(exp, exp, k, stride=stride, groups=exp, act=act))
        if use_se:
            layers.append(_SE(exp))
        layers.append(_ConvBNAct(exp, c_out, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


# (kernel, exp, out, SE, act, stride) per the paper
_LARGE = [
    (3, 16, 16, False, "RE", 1), (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1), (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1), (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2), (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1), (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1), (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2), (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
]
_SMALL = [
    (3, 16, 16, True, "RE", 2), (3, 72, 24, False, "RE", 2),
    (3, 88, 24, False, "RE", 1), (5, 96, 40, True, "HS", 2),
    (5, 240, 40, True, "HS", 1), (5, 240, 40, True, "HS", 1),
    (5, 120, 48, True, "HS", 1), (5, 144, 48, True, "HS", 1),
    (5, 288, 96, True, "HS", 2), (5, 576, 96, True, "HS", 1),
    (5, 576, 96, True, "HS", 1),
]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_exp, last_c, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        c_in = _make_divisible(16 * scale)
        layers = [_ConvBNAct(3, c_in, 3, stride=2, act="HS")]
        for k, exp, c_out, se, act, stride in cfg:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(c_out * scale)
            layers.append(_InvertedResidual(c_in, exp_c, out_c, k, stride, se, act))
            c_in = out_c
        exp_c = _make_divisible(last_exp * scale)
        layers.append(_ConvBNAct(c_in, exp_c, 1, act="HS"))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(exp_c, last_c), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_c, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


class MobileNetV3Large(_MobileNetV3):
    """reference mobilenetv3.py MobileNetV3Large."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, 960, 1280, scale, num_classes, with_pool)


class MobileNetV3Small(_MobileNetV3):
    """reference mobilenetv3.py MobileNetV3Small."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, 576, 1024, scale, num_classes, with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)
