"""Functional image transforms over numpy HWC arrays (counterpart of
paddle_tpu/vision/transforms/functional.py).

Reference parity: python/paddle/vision/transforms/functional.py (+ the
cv2/PIL backends there). Transforms are host-side numpy (they run in
DataLoader workers feeding the device; no PIL/cv2 needed), and
`to_tensor` makes the one HWC->CHW tensor on the framework device. A
tensor image (`erase`, `normalize`) is computed with torch where it lies.
OCRSystem crops and resizes its text regions here, on the host, as the
JAX package does.
"""
from __future__ import annotations

import numbers
from contextlib import nullcontext as _nullcontext

import numpy as np
import torch

from ...framework import device as _device


def _np(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, order="C")).to(_device.current_device())


def to_tensor(pic, data_format="CHW") -> torch.Tensor:
    arr = _np(pic)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if data_format == "CHW":
        arr = np.transpose(arr, (2, 0, 1))
    return _tensor(arr)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = _np(img).astype(np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    out = (arr - mean) / std
    return _tensor(out) if isinstance(img, torch.Tensor) else out


def hflip(img):
    arr = _np(img)
    return arr[:, ::-1, :] if arr.ndim == 3 else arr[:, ::-1]


def vflip(img):
    arr = _np(img)
    return arr[::-1]


def resize(img, size, interpolation="bilinear"):
    """Bilinear (align_corners=False centres) or nearest resize in numpy.
    An int size sets the shorter side and keeps the aspect ratio."""
    arr = _np(img)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    h, w = arr.shape[:2]
    if isinstance(size, int):
        # shorter side -> size, keep aspect (reference semantics)
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
    else:  # bilinear, align_corners=False convention
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


def crop(img, top, left, height, width):
    arr = _np(img)
    return arr[top : top + height, left : left + width]


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    arr = _np(img)
    h, w = arr.shape[:2]
    th, tw = output_size
    top = max(0, (h - th) // 2)
    left = max(0, (w - tw) // 2)
    return crop(arr, top, left, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = _np(img)
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    if len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    left, top, right, bottom = padding
    spec = [(top, bottom), (left, right)] + [(0, 0)] * (arr.ndim - 2)
    if padding_mode == "constant":
        return np.pad(arr, spec, mode="constant", constant_values=fill)
    return np.pad(arr, spec, mode={"reflect": "reflect", "edge": "edge", "symmetric": "symmetric"}[padding_mode])


def adjust_brightness(img, brightness_factor):
    arr = _np(img).astype(np.float32) * brightness_factor
    return np.clip(arr, 0, 255).astype(np.uint8) if _np(img).dtype == np.uint8 else arr


def adjust_contrast(img, contrast_factor):
    arr = _np(img).astype(np.float32)
    mean = arr.mean()
    out = (arr - mean) * contrast_factor + mean
    return np.clip(out, 0, 255).astype(np.uint8) if _np(img).dtype == np.uint8 else out


def adjust_saturation(img, saturation_factor):
    arr = _np(img).astype(np.float32)
    gray = (arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114)[..., None]
    out = gray + (arr - gray) * saturation_factor
    return np.clip(out, 0, 255).astype(np.uint8) if _np(img).dtype == np.uint8 else out


def adjust_hue(img, hue_factor):
    """Approximate hue rotation in RGB space (no colorsys per pixel)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr = _np(img).astype(np.float32)
    theta = hue_factor * 2 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    # YIQ rotation matrix
    t_yiq = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322], [0.211, -0.523, 0.312]], np.float32)
    t_rgb = np.linalg.inv(t_yiq)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    m = t_rgb @ rot @ t_yiq
    out = arr @ m.T
    return np.clip(out, 0, 255).astype(np.uint8) if _np(img).dtype == np.uint8 else out


def rotate(img, angle, interpolation="nearest", expand=False, center=None, fill=0):
    """Nearest-neighbor rotation (host-side; detection aug). expand=True
    enlarges the canvas to hold the whole rotated image."""
    arr = _np(img)
    h, w = arr.shape[:2]
    if expand:
        rad_c = np.deg2rad(angle)
        oh = int(np.ceil(abs(h * np.cos(rad_c)) + abs(w * np.sin(rad_c))))
        ow = int(np.ceil(abs(w * np.cos(rad_c)) + abs(h * np.sin(rad_c))))
        ocy, ocx = (oh - 1) / 2, (ow - 1) / 2
        icy, icx = (h - 1) / 2, (w - 1) / 2
    else:
        oh, ow = h, w
        if center is None:
            ocy = icy = (h - 1) / 2
            ocx = icx = (w - 1) / 2
        else:
            ocy = icy = center[1]
            ocx = icx = center[0]
    rad = -np.deg2rad(angle)
    cos_a, sin_a = np.cos(rad), np.sin(rad)
    yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    ys = cos_a * (yy - ocy) - sin_a * (xx - ocx) + icy
    xs = sin_a * (yy - ocy) + cos_a * (xx - ocx) + icx
    yi = np.round(ys).astype(int)
    xi = np.round(xs).astype(int)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = np.full((oh, ow) + arr.shape[2:], fill, arr.dtype)
    out[valid] = arr[np.clip(yi, 0, h - 1)[valid], np.clip(xi, 0, w - 1)[valid]]
    return out


def to_grayscale(img, num_output_channels=1):
    arr = _np(img).astype(np.float32)
    gray = arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114
    gray = gray[..., None]
    if num_output_channels == 3:
        gray = np.repeat(gray, 3, axis=-1)
    return np.clip(gray, 0, 255).astype(np.uint8) if _np(img).dtype == np.uint8 else gray


def _inverse_warp(arr, inv_matrix, oh=None, ow=None, fill=0):
    """Nearest-neighbor inverse warp: output (y, x) samples input at
    inv_matrix @ [x, y, 1] (host-side numpy, like rotate above)."""
    h, w = arr.shape[:2]
    oh = oh if oh is not None else h
    ow = ow if ow is not None else w
    yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    ones = np.ones_like(xx, np.float64)
    pts = np.stack([xx, yy, ones], 0).reshape(3, -1).astype(np.float64)
    m = np.asarray(inv_matrix, np.float64)
    src = m @ pts
    if m.shape[0] == 3:  # projective: divide by w
        src = src[:2] / np.maximum(np.abs(src[2:3]), 1e-9) * np.sign(src[2:3])
    xs = src[0].reshape(oh, ow)
    ys = src[1].reshape(oh, ow)
    yi = np.round(ys).astype(int)
    xi = np.round(xs).astype(int)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = np.full((oh, ow) + arr.shape[2:], fill, arr.dtype)
    out[valid] = arr[np.clip(yi, 0, h - 1)[valid], np.clip(xi, 0, w - 1)[valid]]
    return out


def affine(img, angle, translate, scale, shear, interpolation="nearest", center=None, fill=0):
    """Affine warp (reference vision/transforms/functional.py affine):
    rotation + translation + isotropic scale + shear, about `center`."""
    arr = _np(img)
    h, w = arr.shape[:2]
    cy, cx = ((h - 1) / 2, (w - 1) / 2) if center is None else (center[1], center[0])
    rot = -np.deg2rad(angle)  # positive angle = counter-clockwise (rotate() convention)
    sx, sy = (np.deg2rad(s) for s in (shear if isinstance(shear, (list, tuple)) else (shear, 0.0)))
    # forward matrix (x, y): T(center) R S Shear T(-center) + translate
    a = np.cos(rot - sy) / np.cos(sy)
    b = -np.cos(rot - sy) * np.tan(sx) / np.cos(sy) - np.sin(rot)
    c = np.sin(rot - sy) / np.cos(sy)
    d = -np.sin(rot - sy) * np.tan(sx) / np.cos(sy) + np.cos(rot)
    m = np.array([[a, b, 0.0], [c, d, 0.0]], np.float64) * scale
    # inverse mapping about center with translation
    full = np.eye(3)
    full[:2, :2] = m[:, :2]
    full[0, 2] = cx + translate[0] - (full[0, 0] * cx + full[0, 1] * cy)
    full[1, 2] = cy + translate[1] - (full[1, 0] * cx + full[1, 1] * cy)
    inv = np.linalg.inv(full)
    return _inverse_warp(arr, inv[:2], fill=fill)


def _perspective_coeffs(startpoints, endpoints):
    """Solve the 8-dof homography mapping endpoints -> startpoints."""
    a = []
    b = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        a.append([ex, ey, 1, 0, 0, 0, -sx * ex, -sx * ey])
        a.append([0, 0, 0, ex, ey, 1, -sy * ex, -sy * ey])
        b += [sx, sy]
    coeffs = np.linalg.lstsq(np.asarray(a, np.float64), np.asarray(b, np.float64), rcond=None)[0]
    return np.concatenate([coeffs, [1.0]]).reshape(3, 3)


def perspective(img, startpoints, endpoints, interpolation="nearest", fill=0):
    """Projective warp mapping startpoints -> endpoints (reference
    functional.perspective; points are [[x, y], ...] corners)."""
    arr = _np(img)
    inv = _perspective_coeffs(startpoints, endpoints)
    return _inverse_warp(arr, inv, fill=fill)


def erase(img, i, j, h, w, v, inplace=False):
    """Erase the [i:i+h, j:j+w] region with value(s) v (reference
    functional.erase). Tensor images are CHW, erased with torch where they
    lie; arrays are HWC host-side."""
    if isinstance(img, torch.Tensor):
        vv = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        region = img[..., i:i + h, j:j + w]
        fill = torch.broadcast_to(vv.to(device=img.device, dtype=img.dtype), region.shape)
        out = img if inplace else img.clone()
        with torch.no_grad() if inplace else _nullcontext():
            out[..., i:i + h, j:j + w] = fill
        return out
    arr = _np(img)
    out = arr if inplace else arr.copy()
    out[i:i + h, j:j + w] = np.asarray(v, out.dtype)
    return out
