"""PP-YOLOE-style anchor-free detector (counterpart of
paddle_tpu/models/detection.py, BASELINE configs[3] on one card): a CSP
backbone (strides 8/16/32), a PAN neck, and decoupled heads (per-cell class
logits and l/t/r/b distances); decode (softplus distances around the cell
centres), infer (score filter and class-aware vision.ops.nms) and the dense
BCE + L1 ppyoloe_loss. The same attribute names and module order as the
JAX package, so the state crosses utils/convert.py by name (no Linear).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..nn.functional import binary_cross_entropy_with_logits, interpolate
from ..vision.ops import nms


def _conv_bn(c_in, c_out, k=3, stride=1, act=True):
    layers = [nn.Conv2D(c_in, c_out, k, stride=stride, padding=k // 2, bias_attr=False),
              nn.BatchNorm2D(c_out)]
    if act:
        layers.append(nn.Silu())
    return nn.Sequential(*layers)


class CSPBlock(nn.Layer):
    def __init__(self, c_in, c_out, n=1):
        super().__init__()
        mid = c_out // 2
        self.a = _conv_bn(c_in, mid, 1)
        self.b = _conv_bn(c_in, mid, 1)
        self.m = nn.Sequential(*[_conv_bn(mid, mid, 3) for _ in range(n)])
        self.out = _conv_bn(2 * mid, c_out, 1)

    def forward(self, x):
        return self.out(torch.cat([self.a(x), self.m(self.b(x))], dim=1))


class CSPBackbone(nn.Layer):
    """The stride 8, 16 and 32 maps."""

    def __init__(self, base=32):
        super().__init__()
        self.stem = _conv_bn(3, base, 3, stride=2)
        self.s1 = nn.Sequential(_conv_bn(base, base * 2, 3, stride=2), CSPBlock(base * 2, base * 2))
        self.s2 = nn.Sequential(_conv_bn(base * 2, base * 4, 3, stride=2), CSPBlock(base * 4, base * 4))
        self.s3 = nn.Sequential(_conv_bn(base * 4, base * 8, 3, stride=2), CSPBlock(base * 8, base * 8))
        self.s4 = nn.Sequential(_conv_bn(base * 8, base * 16, 3, stride=2),
                                CSPBlock(base * 16, base * 16))
        self.out_channels = [base * 4, base * 8, base * 16]

    def forward(self, x):
        x = self.s1(self.stem(x))
        c3 = self.s2(x)
        c4 = self.s3(c3)
        c5 = self.s4(c4)
        return c3, c4, c5


class PANNeck(nn.Layer):
    def __init__(self, in_channels, out_channels=96):
        super().__init__()
        self.lat = nn.LayerList([_conv_bn(c, out_channels, 1) for c in in_channels])
        self.td = nn.LayerList([CSPBlock(2 * out_channels, out_channels) for _ in range(2)])
        self.down = nn.LayerList([_conv_bn(out_channels, out_channels, 3, stride=2) for _ in range(2)])
        self.bu = nn.LayerList([CSPBlock(2 * out_channels, out_channels) for _ in range(2)])
        self.out_channels = out_channels

    def forward(self, feats):
        p3, p4, p5 = [lat(f) for lat, f in zip(self.lat, feats)]
        t4 = self.td[0](torch.cat([p4, interpolate(p5, scale_factor=2, mode="nearest")], dim=1))
        t3 = self.td[1](torch.cat([p3, interpolate(t4, scale_factor=2, mode="nearest")], dim=1))
        b4 = self.bu[0](torch.cat([t4, self.down[0](t3)], dim=1))
        b5 = self.bu[1](torch.cat([p5, self.down[1](b4)], dim=1))
        return t3, b4, b5


class DecoupledHead(nn.Layer):
    def __init__(self, c_in, num_classes):
        super().__init__()
        self.cls_conv = _conv_bn(c_in, c_in, 3)
        self.reg_conv = _conv_bn(c_in, c_in, 3)
        self.cls_pred = nn.Conv2D(c_in, num_classes, 1)
        self.reg_pred = nn.Conv2D(c_in, 4, 1)

    def forward(self, x):
        return self.cls_pred(self.cls_conv(x)), self.reg_pred(self.reg_conv(x))


class PPYOLOE(nn.Layer):
    strides = (8, 16, 32)

    def __init__(self, num_classes=80, base_channels=32, neck_channels=96):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = CSPBackbone(base_channels)
        self.neck = PANNeck(self.backbone.out_channels, neck_channels)
        self.heads = nn.LayerList([DecoupledHead(neck_channels, num_classes) for _ in self.strides])

    def forward(self, x):
        """Per level (class logits [B, C, H, W], distances [B, 4, H, W])."""
        feats = self.neck(self.backbone(x))
        return [head(f) for head, f in zip(self.heads, feats)]

    def decode(self, outputs):
        """All levels flattened: boxes [B, N, 4] (x1, y1, x2, y2 in input
        pixels) and sigmoid scores [B, N, C]. A distance is
        logaddexp(r, 0) * stride (softplus) from the cell centre
        ((i + 0.5) * stride)."""
        boxes_all, scores_all = [], []
        for (cls, reg), stride in zip(outputs, self.strides):
            b, c, h, w = cls.shape
            d = torch.logaddexp(reg, torch.zeros((), dtype=reg.dtype, device=reg.device)) * stride
            gy = (torch.arange(h, dtype=torch.float32, device=reg.device) + 0.5) * stride
            gx = (torch.arange(w, dtype=torch.float32, device=reg.device) + 0.5) * stride
            cx, cy = gx[None, None, None, :], gy[None, None, :, None]
            out = torch.cat([cx - d[:, 0:1], cy - d[:, 1:2], cx + d[:, 2:3], cy + d[:, 3:4]], dim=1)
            boxes_all.append(out.reshape(b, 4, -1).transpose(1, 2))
            scores_all.append(torch.sigmoid(cls).reshape(b, c, h * w).transpose(1, 2))
        return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)

    def infer(self, x, score_thresh=0.4, iou_thresh=0.5, top_k=100):
        """[B, 3, H, W] -> per image a float32 [n, 6] array (x1, y1, x2, y2,
        score, class). The score filter and the class-aware nms run on the
        images' device."""
        self.eval()
        with torch.no_grad():
            boxes, scores = self.decode(self.forward(x))
            results = []
            for bi in range(boxes.shape[0]):
                conf, cls_id = scores[bi].max(-1)
                keep_mask = conf >= score_thresh
                if not bool(keep_mask.any()):
                    results.append(np.zeros((0, 6), np.float32))
                    continue
                bb, cc, kk = boxes[bi][keep_mask], conf[keep_mask], cls_id[keep_mask]
                keep = nms(bb, iou_thresh, scores=cc, category_idxs=kk,
                           categories=list(range(self.num_classes)), top_k=top_k)
                results.append(torch.cat([bb[keep], cc[keep, None], kk[keep, None].float()],
                                         dim=1).cpu().numpy())
        return results


def ppyoloe_loss(outputs, targets, num_classes):
    """Dense per-level loss. `targets` is a list over levels of dicts:
    'cls' [B, C, H, W] one-hot maps, 'box' [B, 4, H, W] distances (l, t, r,
    b, in the softplus space of the raw outputs), 'mask' [B, 1, H, W] the
    positive cells. Mean BCE over every cell and class per level, plus the
    L1 of the distances at positive cells over 4x their count."""
    total_cls, total_box, npos = 0.0, 0.0, 0.0
    for (cls, reg), tgt in zip(outputs, targets):
        total_cls = total_cls + binary_cross_entropy_with_logits(cls, tgt["cls"], reduction="mean")
        m = tgt["mask"]
        total_box = total_box + ((reg - tgt["box"]).abs() * m).sum()
        npos = npos + m.sum() * 4.0
    return total_cls + total_box / (npos + 1e-6)
