"""Box ops (counterpart of paddle_tpu/vision/ops.py:27-78): box_area,
box_iou and nms.

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
