"""PP-OCR-style text detection and recognition (counterpart of
paddle_tpu/models/ocr.py, BASELINE configs[2], PP-OCRv4 det+rec):

- DBNet: a 4-stage strided conv backbone, an FPN neck fused to 1/4
  resolution, and the Differentiable Binarization head (prob, threshold and
  approximate binary maps, each up to the input size by two stride-2
  transposed convs); db_loss;
- CRNN: a conv stack that collapses the height, two BiLSTMs and a CTC
  head, trained with nn.functional.ctc_loss and greedy-decoded;
- OCRSystem: det on the page, boxes from the prob map on the host,
  crops resized on the host, rec on the crops.

The same attribute names and module order as the JAX package, so the
state crosses utils/convert.py by name (CRNN.fc is the one Linear). The
host functions take a tensor on the card by .detach().cpu().numpy().
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..nn.functional import interpolate
from ..vision.transforms.functional import _np as _host
from ..vision.transforms.functional import resize as np_resize


def _conv_bn(c_in, c_out, k=3, stride=1, padding=None, act=True):
    padding = (k // 2) if padding is None else padding
    layers = [nn.Conv2D(c_in, c_out, k, stride=stride, padding=padding, bias_attr=False),
              nn.BatchNorm2D(c_out)]
    if act:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class _DetBackbone(nn.Layer):
    """4 strided stages emitting the {1/4, 1/8, 1/16, 1/32} maps."""

    def __init__(self, base=16):
        super().__init__()
        self.stem = _conv_bn(3, base, 3, stride=2)
        self.stage1 = nn.Sequential(_conv_bn(base, base * 2, 3, stride=2), _conv_bn(base * 2, base * 2))
        self.stage2 = nn.Sequential(_conv_bn(base * 2, base * 4, 3, stride=2), _conv_bn(base * 4, base * 4))
        self.stage3 = nn.Sequential(_conv_bn(base * 4, base * 8, 3, stride=2), _conv_bn(base * 8, base * 8))
        self.stage4 = nn.Sequential(_conv_bn(base * 8, base * 16, 3, stride=2),
                                    _conv_bn(base * 16, base * 16))
        self.out_channels = [base * 2, base * 4, base * 8, base * 16]

    def forward(self, x):
        x = self.stem(x)
        c2 = self.stage1(x)
        c3 = self.stage2(c2)
        c4 = self.stage3(c3)
        c5 = self.stage4(c4)
        return c2, c3, c4, c5


class _DBFPN(nn.Layer):
    """Top-down fuse to one 1/4-resolution feature (PaddleOCR's DBFPN)."""

    def __init__(self, in_channels, out_channels=96):
        super().__init__()
        self.lat = nn.LayerList([nn.Conv2D(c, out_channels, 1, bias_attr=False) for c in in_channels])
        self.smooth = nn.LayerList([nn.Conv2D(out_channels, out_channels // 4, 3, padding=1,
                                              bias_attr=False) for _ in in_channels])
        self.out_channels = out_channels

    def forward(self, feats):
        c2, c3, c4, c5 = feats
        p5 = self.lat[3](c5)
        p4 = self.lat[2](c4) + interpolate(p5, scale_factor=2, mode="nearest")
        p3 = self.lat[1](c3) + interpolate(p4, scale_factor=2, mode="nearest")
        p2 = self.lat[0](c2) + interpolate(p3, scale_factor=2, mode="nearest")
        return torch.cat([self.smooth[0](p2),
                          interpolate(self.smooth[1](p3), scale_factor=2, mode="nearest"),
                          interpolate(self.smooth[2](p4), scale_factor=4, mode="nearest"),
                          interpolate(self.smooth[3](p5), scale_factor=8, mode="nearest")], dim=1)


class _DBHead(nn.Layer):
    def __init__(self, c_in, k=50):
        super().__init__()
        self.k = k

        def branch():
            return nn.Sequential(
                nn.Conv2D(c_in, c_in // 4, 3, padding=1, bias_attr=False),
                nn.BatchNorm2D(c_in // 4),
                nn.ReLU(),
                nn.Conv2DTranspose(c_in // 4, c_in // 4, 2, stride=2),
                nn.BatchNorm2D(c_in // 4),
                nn.ReLU(),
                nn.Conv2DTranspose(c_in // 4, 1, 2, stride=2),
                nn.Sigmoid(),
            )

        self.prob = branch()
        self.thresh = branch()

    def forward(self, x):
        p = self.prob(x)
        if not self.training:
            return p
        t = self.thresh(x)
        # differentiable binarization: b = 1 / (1 + exp(-k (p - t)))
        b = 1.0 / (1.0 + torch.exp(-self.k * (p - t)))
        return torch.cat([p, t, b], dim=1)


class DBNet(nn.Layer):
    """Text detector. Train: [B, 3, H, W] (prob, thresh, binary) maps at the
    input resolution; eval: the prob map only."""

    def __init__(self, base_channels=16, neck_channels=96, k=50):
        super().__init__()
        self.backbone = _DetBackbone(base_channels)
        self.neck = _DBFPN(self.backbone.out_channels, neck_channels)
        self.head = _DBHead(neck_channels, k)

    def forward(self, x):
        return self.head(self.neck(self.backbone(x)))


def db_loss(pred, gt_prob, gt_thresh, prob_mask=None, thresh_mask=None, alpha=5.0, beta=10.0,
            eps=1e-6):
    """alpha * BCE on the prob map + beta * L1 on the threshold map + dice
    on the binary map."""
    p = pred[:, 0:1].clamp(eps, 1 - eps)
    t = pred[:, 1:2]
    b = pred[:, 2:3].clamp(eps, 1 - eps)
    pm = prob_mask if prob_mask is not None else 1.0
    tm = thresh_mask if thresh_mask is not None else 1.0
    bce = -(gt_prob * torch.log(p) + (1.0 - gt_prob) * torch.log(1.0 - p))
    bce = (bce * pm).mean()
    l1 = ((t - gt_thresh).abs() * tm).mean()
    inter = (b * gt_prob * pm).sum()
    union = (b * pm).sum() + (gt_prob * pm).sum() + eps
    dice = 1.0 - 2.0 * inter / union
    return alpha * bce + beta * l1 + dice


def db_postprocess(prob_map, bin_thresh=0.3, box_thresh=0.6, min_area=4):
    """Host-side boxes from the prob map: the 4-connected components of
    the binarized map -> axis-aligned [x1, y1, x2, y2, score] boxes, one
    float32 [n, 5] array per image. scipy.ndimage labels the components;
    without scipy, a flood fill finds the same ones."""
    pm = _host(prob_map)
    try:
        from scipy import ndimage as ndi
    except ImportError:
        ndi = None
    out = []
    for b in range(pm.shape[0]):
        bitmap = pm[b, 0] > bin_thresh
        boxes = []
        if ndi is not None:
            labels, n = ndi.label(bitmap, structure=[[0, 1, 0], [1, 1, 1], [0, 1, 0]])
            if n:
                idx = np.arange(1, n + 1)
                areas = ndi.sum_labels(bitmap, labels, idx)
                scores = ndi.mean(pm[b, 0], labels, idx)
                keep = (areas >= min_area) & (scores >= box_thresh)
                slices = ndi.find_objects(labels)
                for i in np.nonzero(keep)[0]:
                    sy, sx = slices[i]
                    boxes.append([sx.start, sy.start, sx.stop, sy.stop, float(scores[i])])
        else:
            visited = np.zeros_like(bitmap, dtype=bool)
            h, w = bitmap.shape
            for y in range(h):
                for x in range(w):
                    if bitmap[y, x] and not visited[y, x]:
                        stack = [(y, x)]
                        visited[y, x] = True
                        ys, xs = [], []
                        while stack:
                            cy, cx = stack.pop()
                            ys.append(cy)
                            xs.append(cx)
                            for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                                ny, nx = cy + dy, cx + dx
                                if (0 <= ny < h and 0 <= nx < w and bitmap[ny, nx]
                                        and not visited[ny, nx]):
                                    visited[ny, nx] = True
                                    stack.append((ny, nx))
                        if len(ys) >= min_area:
                            score = float(pm[b, 0, ys, xs].mean())
                            if score >= box_thresh:
                                boxes.append([min(xs), min(ys), max(xs) + 1, max(ys) + 1, score])
        out.append(np.asarray(boxes, np.float32).reshape(-1, 5))
    return out


class CRNN(nn.Layer):
    """Conv stack (the height collapses to 1) -> 2 BiLSTMs -> class logits.
    Input [B, C, 32, W]; output [B, W/4 - 1, num_classes] (blank = 0)."""

    def __init__(self, in_channels=3, num_classes=37, hidden_size=96):
        super().__init__()
        self.convs = nn.Sequential(
            _conv_bn(in_channels, 32, 3),
            nn.MaxPool2D(2, 2),  # 16 x W/2
            _conv_bn(32, 64, 3),
            nn.MaxPool2D(2, 2),  # 8 x W/4
            _conv_bn(64, 128, 3),
            _conv_bn(128, 128, 3),
            nn.MaxPool2D((2, 1), (2, 1)),  # 4 x W/4
            _conv_bn(128, 192, 3),
            nn.MaxPool2D((2, 1), (2, 1)),  # 2 x W/4
            _conv_bn(192, 192, 2, padding=0),  # 1 x (W/4 - 1)
        )
        self.rnn1 = nn.BiRNN(nn.LSTMCell(192, hidden_size), nn.LSTMCell(192, hidden_size))
        self.rnn2 = nn.BiRNN(nn.LSTMCell(2 * hidden_size, hidden_size),
                             nn.LSTMCell(2 * hidden_size, hidden_size))
        self.fc = nn.Linear(2 * hidden_size, num_classes)
        self.num_classes = num_classes

    def forward(self, x):
        feat = self.convs(x).squeeze(2).transpose(1, 2)  # [B, T, C]
        out, _ = self.rnn1(feat)
        out, _ = self.rnn2(out)
        return self.fc(out)


def ctc_greedy_decode(logits, blank=0):
    """[B, T, C] logits -> one label list per row (repeats merged, blanks
    dropped)."""
    pred = _host(logits).argmax(-1)
    out = []
    for row in pred:
        seq, prev = [], -1
        for p in row:
            if p != prev and p != blank:
                seq.append(int(p))
            prev = p
        out.append(seq)
    return out


class OCRSystem(nn.Layer):
    """det + rec (the PP-OCR pipeline): boxes on the full page, each region
    cropped and resized on the host, then recognized by the CRNN."""

    def __init__(self, det: DBNet = None, rec: CRNN = None, rec_image_shape=(3, 32, 100)):
        super().__init__()
        self.det = det or DBNet()
        self.rec = rec or CRNN()
        self.rec_image_shape = rec_image_shape

    def forward(self, images):
        """Inference only: per image, a list of (box, label ids)."""
        self.eval()
        with torch.no_grad():
            boxes_per_img = db_postprocess(self.det(images))
            imgs = _host(images)
            results = []
            _, th, tw = self.rec_image_shape
            for i, boxes in enumerate(boxes_per_img):
                crops, kept_boxes = [], []
                for bx in boxes:
                    x1, y1, x2, y2 = (int(v) for v in bx[:4])
                    crop = imgs[i, :, y1:y2, x1:x2]
                    if crop.shape[1] < 1 or crop.shape[2] < 1:
                        continue  # a degenerate region: its box goes too
                    hwc = np_resize(np.transpose(crop, (1, 2, 0)).astype(np.float32), (th, tw))
                    crops.append(np.transpose(hwc, (2, 0, 1)))
                    kept_boxes.append(bx[:4].tolist())
                if not crops:
                    results.append([])
                    continue
                logits = self.rec(torch.from_numpy(np.stack(crops)).to(images.device))
                results.append(list(zip(kept_boxes, ctc_greedy_decode(logits))))
        return results
