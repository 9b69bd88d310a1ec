"""Transform classes (counterpart of
paddle_tpu/vision/transforms/transforms.py; reference:
python/paddle/vision/transforms/transforms.py). The random transforms draw
from Python's `random` and from `np.random` exactly where the JAX package
does, so one `random.seed` / `np.random.seed` gives both packages the same
crops, flips and factors."""
from __future__ import annotations

import numbers
import random

import numpy as np

from . import functional as F


class BaseTransform:
    """Reference BaseTransform: callable on img or (img, target) pairs."""

    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def __repr__(self):
        return "Compose(" + ", ".join(repr(t) for t in self.transforms) + ")"


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return F.hflip(img) if random.random() < self.prob else img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return F.vflip(img) if random.random() < self.prob else img


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        if self.padding is not None:
            img = F.pad(img, self.padding, self.fill, self.padding_mode)
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            img = F.pad(arr, (0, 0, max(0, tw - w), max(0, th - h)), self.fill, self.padding_mode)
            arr = np.asarray(img)
            h, w = arr.shape[:2]
        top = random.randint(0, h - th)
        left = random.randint(0, w - tw)
        return F.crop(arr, top, left, th, tw)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            aspect = np.exp(random.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                patch = F.crop(arr, top, left, ch, cw)
                return F.resize(patch, self.size, self.interpolation)
        return F.resize(F.center_crop(arr, min(h, w)), self.size, self.interpolation)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False, center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation = interpolation
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return F.rotate(img, angle, self.interpolation, center=self.center, fill=self.fill)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        super().__init__(keys)
        self.brightness = brightness
        self.contrast = contrast
        self.hue = hue
        self.saturation = saturation

    def _apply_image(self, img):
        if self.brightness:
            img = F.adjust_brightness(img, random.uniform(max(0, 1 - self.brightness), 1 + self.brightness))
        if self.contrast:
            img = F.adjust_contrast(img, random.uniform(max(0, 1 - self.contrast), 1 + self.contrast))
        if self.saturation:
            img = F.adjust_saturation(img, random.uniform(max(0, 1 - self.saturation), 1 + self.saturation))
        if self.hue:
            img = F.adjust_hue(img, random.uniform(-self.hue, self.hue))
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.transpose(arr, self.order)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3), value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        arr = np.array(img, copy=True)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[0] < arr.shape[-1]
        h, w = (arr.shape[1], arr.shape[2]) if chw else (arr.shape[0], arr.shape[1])
        area = h * w
        for _ in range(10):
            target = area * random.uniform(*self.scale)
            aspect = np.exp(random.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            eh, ew = int(round(np.sqrt(target / aspect))), int(round(np.sqrt(target * aspect)))
            if eh < h and ew < w:
                top, left = random.randint(0, h - eh), random.randint(0, w - ew)
                if chw:
                    arr[:, top : top + eh, left : left + ew] = self.value
                else:
                    arr[top : top + eh, left : left + ew] = self.value
                break
        return arr


# ---------------------------------------------------------------------------
# r3 transform completion (vision namespace parity audit)
# ---------------------------------------------------------------------------

class BrightnessTransform(BaseTransform):
    """Random brightness in [max(0, 1-value), 1+value] (reference
    transforms.BrightnessTransform)."""

    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("brightness value should be non-negative")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_brightness(img, factor)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("contrast value should be non-negative")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("saturation value should be non-negative")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_saturation(img, factor)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value should be in [0, 0.5]")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = np.random.uniform(-self.value, self.value)
        return F.adjust_hue(img, factor)


class RandomAffine(BaseTransform):
    """Random rotation + translation + scale + shear (reference
    transforms.RandomAffine)."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        arr = F._np(img)
        h, w = arr.shape[:2]
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        scale = np.random.uniform(*self.scale) if self.scale is not None else 1.0
        if self.shear is not None:
            sh = self.shear if isinstance(self.shear, (list, tuple)) else (-self.shear, self.shear)
            if len(sh) == 2:
                shear = (np.random.uniform(sh[0], sh[1]), 0.0)
            else:
                shear = (np.random.uniform(sh[0], sh[1]), np.random.uniform(sh[2], sh[3]))
        else:
            shear = (0.0, 0.0)
        return F.affine(img, angle, (tx, ty), scale, shear,
                        interpolation=self.interpolation, center=self.center, fill=self.fill)


class RandomPerspective(BaseTransform):
    """Random projective distortion (reference transforms.RandomPerspective)."""

    def __init__(self, prob=0.5, distortion_scale=0.5, interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _get_params(self, w, h):
        d = self.distortion_scale
        hd = int(d * h / 2)
        wd = int(d * w / 2)
        start = [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]
        end = [
            [np.random.randint(0, wd + 1), np.random.randint(0, hd + 1)],
            [w - 1 - np.random.randint(0, wd + 1), np.random.randint(0, hd + 1)],
            [w - 1 - np.random.randint(0, wd + 1), h - 1 - np.random.randint(0, hd + 1)],
            [np.random.randint(0, wd + 1), h - 1 - np.random.randint(0, hd + 1)],
        ]
        return start, end

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        arr = F._np(img)
        h, w = arr.shape[:2]
        start, end = self._get_params(w, h)
        return F.perspective(img, start, end, interpolation=self.interpolation, fill=self.fill)
