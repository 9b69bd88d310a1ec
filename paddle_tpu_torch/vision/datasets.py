"""paddle.vision.datasets (counterpart of paddle_tpu/vision/datasets.py).

Reference parity: python/paddle/vision/datasets/ (MNIST/FashionMNIST/
Cifar10/Cifar100/Flowers/VOC2012 with auto-download). Nothing is
downloaded (`download=True` is accepted and downloads nothing): each
dataset loads from local files when given and otherwise generates a
deterministic synthetic sample set with the exact shapes/dtypes/label
spaces of the real dataset, from the same seeded numpy draws as the JAX
package's, so both packages hold the same samples.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io import Dataset


class _SyntheticImageDataset(Dataset):
    IMAGE_SHAPE = (28, 28)  # HW or HWC
    NUM_CLASSES = 10
    TRAIN_N = 512
    TEST_N = 128

    def __init__(self, mode="train", transform=None, backend="numpy", seed=0):
        assert mode in ("train", "test"), f"mode must be train/test, got {mode}"
        self.mode = mode
        self.transform = transform
        n = self.TRAIN_N if mode == "train" else self.TEST_N
        rng = np.random.RandomState(seed + (0 if mode == "train" else 1))
        self.images = rng.randint(0, 256, (n,) + self.IMAGE_SHAPE, dtype=np.uint8)
        self.labels = rng.randint(0, self.NUM_CLASSES, (n,)).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([label], dtype=np.int64)

    def __len__(self):
        return len(self.images)


class MNIST(_SyntheticImageDataset):
    """MNIST; reads IDX files when image_path/label_path are given
    (same file format the reference downloads), else synthetic."""

    IMAGE_SHAPE = (28, 28)
    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train", transform=None, download=True, backend="numpy"):
        if (image_path or label_path) and not (
            image_path and label_path and os.path.exists(image_path) and os.path.exists(label_path)
        ):
            raise FileNotFoundError(
                f"MNIST files not found: {image_path!r} / {label_path!r} (nothing is downloaded)"
            )
        if image_path and label_path:
            self.mode = mode
            self.transform = transform
            with gzip.open(image_path, "rb") as f:
                _, num, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(f.read(), np.uint8).reshape(num, rows, cols)
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                self.labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
        else:
            super().__init__(mode=mode, transform=transform)


class FashionMNIST(MNIST):
    pass


class Cifar10(_SyntheticImageDataset):
    IMAGE_SHAPE = (32, 32, 3)
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None, download=True, backend="numpy"):
        if data_file and os.path.exists(data_file):
            raise NotImplementedError("loading real CIFAR archives is not supported; the dataset "
                                      "is synthetic")
        super().__init__(mode=mode, transform=transform)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class Flowers(_SyntheticImageDataset):
    IMAGE_SHAPE = (64, 64, 3)
    NUM_CLASSES = 102
    TRAIN_N = 256
    TEST_N = 64

    def __init__(self, data_file=None, label_file=None, setid_file=None, mode="train", transform=None, download=True, backend="numpy"):
        super().__init__(mode=mode, transform=transform)


class DatasetFolder(Dataset):
    """Reference DatasetFolder: class-per-subdirectory image tree. Images
    are .npy arrays by default (extension filter `.npy`); pass `loader`
    and `extensions` for other files."""

    def __init__(self, root, loader=None, extensions=(".npy",), transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or (lambda p: np.load(p))
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            for fn in sorted(os.listdir(os.path.join(root, c))):
                if fn.endswith(tuple(extensions)):
                    self.samples.append((os.path.join(root, c, fn), self.class_to_idx[c]))
        self.classes = classes

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Reference ImageFolder: yields images (no labels) from files directly
    under root (recursing into subdirectories)."""

    def __init__(self, root, loader=None, extensions=(".npy",), transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or (lambda p: np.load(p))
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                if fn.endswith(tuple(extensions)):
                    self.samples.append(os.path.join(dirpath, fn))

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class VOC2012(Dataset):
    """Synthetic VOC2012-shaped segmentation dataset (reference
    vision/datasets/voc2012.py: (image HWC uint8, label mask HW uint8 with
    class ids 0..20 + 255 ignore))."""

    IMAGE_SHAPE = (64, 64, 3)
    NUM_CLASSES = 21
    TRAIN_N = 128
    TEST_N = 32

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="numpy", seed=0):
        assert mode in ("train", "valid", "test"), (
            f"mode must be train/valid/test, got {mode}"
        )
        self.mode = mode
        self.transform = transform
        n = self.TRAIN_N if mode == "train" else self.TEST_N
        rng = np.random.RandomState(seed + {"train": 0, "valid": 1, "test": 2}[mode])
        self.images = rng.randint(0, 256, (n,) + self.IMAGE_SHAPE, dtype=np.uint8)
        masks = rng.randint(0, self.NUM_CLASSES, (n,) + self.IMAGE_SHAPE[:2])
        border = rng.rand(n, *self.IMAGE_SHAPE[:2]) < 0.05
        masks = np.where(border, 255, masks)
        self.labels = masks.astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)
