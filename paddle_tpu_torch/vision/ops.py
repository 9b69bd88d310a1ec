"""Box ops and the deformable conv (counterpart of
paddle_tpu/vision/ops.py:27-78 and :203-285, 819-838): box_area, box_iou,
nms, deform_conv2d and DeformConv2D.

nms gives the JAX package's indices. The JAX package sorts by score
(stable), offsets the boxes of each category by category * (the largest
x2/y2 + 1), builds one [n, n] IoU matrix and runs the greedy pass as a
compiled loop over the sorted boxes: box i is kept unless a kept box j < i
has IoU > threshold with it. One torch op a box would be n launches (8400
at PP-YOLOE's 640 x 640 with untrained weights), so the pass here is a
fixed point on the card: with S[i, j] = (IoU > threshold and j < i),
keep = not (S @ keep > 0), swept from keep = all until it stops changing.
Box i is final once every box that can suppress it is, so the sweep count
is the longest chain of suppressions plus one, and the fixed point is
unique: it is the greedy pass's answer. The sums count 0/1 products
exactly in f32.
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ..core import record as _record
from ..nn.layer import Layer as _Layer

LAST_SWEEPS = 0  # sweeps of the last nms call (read by the card's smoke run)


def box_area(boxes):
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def box_iou(a, b):
    """[n, m] IoU of boxes a [n, 4] and b [m, 4] (x1, y1, x2, y2), in the
    JAX package's arithmetic, element by element: intersection width and
    height clipped at 0, over max(union, 1e-10)."""
    area_a, area_b = box_area(a), box_area(b)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2]) - torch.maximum(a[:, None, 0], b[None, :, 0]))
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3]) - torch.maximum(a[:, None, 1], b[None, :, 1]))
    inter = iw.clamp_min(0) * ih.clamp_min(0)
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp_min(1e-10)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None, categories=None, top_k=None):
    """paddle.vision.ops.nms: the kept indices (int64, on the boxes'
    device) in descending score order (box order without scores), the
    first `top_k` of them. With category_idxs, boxes of different
    categories never suppress each other."""
    global LAST_SWEEPS
    n = boxes.shape[0]
    if scores is not None:
        order = torch.argsort(-scores, stable=True)
    else:
        order = torch.arange(n, device=boxes.device)
    sorted_boxes = boxes[order]
    if category_idxs is not None:
        span = boxes[:, 2:].max() + 1.0
        sorted_boxes = sorted_boxes + (category_idxs[order].to(boxes.dtype) * span)[:, None]
    sup = (box_iou(sorted_boxes, sorted_boxes) > iou_threshold).tril(-1).float()
    keep = torch.ones(n, dtype=torch.float32, device=boxes.device)
    sweeps = 0
    while True:
        sweeps += 1
        new = ((sup @ keep) == 0).float()
        if torch.equal(new, keep):
            break
        keep = new
    LAST_SWEEPS = sweeps
    kept = order[keep.bool()]
    return kept[:top_k] if top_k is not None else kept


# ---------------------------------------------------------------------------
# deformable conv
# ---------------------------------------------------------------------------

def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


@_record.op
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0, dilation=1,
                  deformable_groups=1, groups=1, mask=None, name=None):
    """Deformable conv v1 (v2 with `mask`) as the JAX package computes it:
    each kernel point samples the zero-padded input bilinearly at its
    offset position (a corner outside the padded map reads 0), the
    samples are scaled by the mask, then contracted with the weight.
    `offset` is [N, 2*kh*kw, oh, ow] as (dy, dx) pairs per kernel point.
    One group and one deformable group, as in the JAX package."""
    if groups != 1 or deformable_groups != 1:
        raise NotImplementedError("deform_conv2d: groups/deformable_groups > 1 not yet supported")
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    n, c, h, w = x.shape
    oc, ic, kh, kw = weight.shape
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = TF.pad(x, (pw, pw, ph, ph))
    hp, wp = h + 2 * ph, w + 2 * pw
    dev = x.device
    ar = lambda k, step: torch.arange(k, device=dev) * step
    base_y = (ar(oh, sh)[:, None, None, None] + ar(kh, dh)[None, None, :, None]).expand(
        oh, ow, kh, kw).float()
    base_x = (ar(ow, sw)[None, :, None, None] + ar(kw, dw)[None, None, None, :]).expand(
        oh, ow, kh, kw).float()
    off = offset.reshape(n, kh * kw, 2, oh, ow)
    sy = base_y[None] + off[:, :, 0].movedim(1, -1).reshape(n, oh, ow, kh, kw)
    sx = base_x[None] + off[:, :, 1].movedim(1, -1).reshape(n, oh, ow, kh, kw)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[:, None], (sx - x0)[:, None]
    flat = xp.reshape(n, c, hp * wp)

    def gather(yy, xx):  # [N, C, oh, ow, kh, kw]
        yi = yy.clamp(0, hp - 1).long()
        xi = xx.clamp(0, wp - 1).long()
        valid = (yy >= 0) & (yy <= hp - 1) & (xx >= 0) & (xx <= wp - 1)
        idx = (yi * wp + xi).reshape(n, 1, -1).expand(n, c, -1)
        vals = torch.gather(flat, 2, idx).reshape(n, c, oh, ow, kh, kw)
        return vals * valid[:, None].to(x.dtype)

    s = (gather(y0, x0) * (1 - wy) * (1 - wx) + gather(y0, x0 + 1) * (1 - wy) * wx
         + gather(y0 + 1, x0) * wy * (1 - wx) + gather(y0 + 1, x0 + 1) * wy * wx)
    if mask is not None:
        s = s * mask.reshape(n, kh * kw, oh, ow).movedim(1, -1).reshape(n, 1, oh, ow, kh, kw)
    out = torch.einsum("ncyxhw,ochw->noyx", s, weight)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class DeformConv2D(_Layer):
    """deform_conv2d's layer: it owns the weight [out, in // groups, kh, kw]
    and the bias (none with bias_attr=False)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, deformable_groups=1, groups=1, weight_attr=None, bias_attr=None):
        super().__init__()
        k = _pair(kernel_size)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, k[0], k[1]], attr=weight_attr)
        self.bias = (None if bias_attr is False
                     else self.create_parameter([out_channels], attr=bias_attr, is_bias=True))
        self.args = (stride, padding, dilation, deformable_groups, groups)

    def forward(self, x, offset, mask=None):
        s, p, d, dg, g = self.args
        return deform_conv2d(x, offset, self.weight, self.bias, s, p, d, dg, g, mask)
