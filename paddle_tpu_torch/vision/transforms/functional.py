"""Host-side image transforms over numpy HWC arrays (a copy of resize and
_np from paddle_tpu/vision/transforms/functional.py:17-96; the port keeps
its own copy and imports nothing of the JAX package). OCRSystem crops and
resizes its text regions here, on the host, as the JAX package does."""
from __future__ import annotations

import numpy as np
import torch


def _np(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def resize(img, size, interpolation="bilinear"):
    """Bilinear (align_corners=False centres) or nearest resize in numpy.
    An int size sets the shorter side and keeps the aspect ratio."""
    arr = _np(img)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    h, w = arr.shape[:2]
    if isinstance(size, int):
        if h < w:
            oh, ow = size, max(1, int(round(w * size / h)))
        else:
            oh, ow = max(1, int(round(h * size / w))), size
    else:
        oh, ow = size
    if (oh, ow) == (h, w):
        return arr[:, :, 0] if squeeze else arr
    if interpolation == "nearest":
        ys = np.clip(np.round(np.arange(oh) * h / oh).astype(int), 0, h - 1)
        xs = np.clip(np.round(np.arange(ow) * w / ow).astype(int), 0, w - 1)
        out = arr[ys][:, xs]
    else:
        y = (np.arange(oh) + 0.5) * h / oh - 0.5
        x = (np.arange(ow) + 0.5) * w / ow - 0.5
        y0 = np.clip(np.floor(y).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(x).astype(int), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(y - y0, 0, 1)[:, None, None]
        wx = np.clip(x - x0, 0, 1)[None, :, None]
        a = arr[y0][:, x0].astype(np.float32)
        b = arr[y0][:, x1].astype(np.float32)
        c = arr[y1][:, x0].astype(np.float32)
        d = arr[y1][:, x1].astype(np.float32)
        out = a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx
        if arr.dtype == np.uint8:
            out = np.clip(np.round(out), 0, 255).astype(np.uint8)
        else:
            out = out.astype(arr.dtype)
    return out[:, :, 0] if squeeze else out
