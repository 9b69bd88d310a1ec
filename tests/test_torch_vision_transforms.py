"""Port parity for vision/transforms and vision/datasets: every functional
and every transform class on the same seeded images under one
`random.seed` / `np.random.seed` against the JAX package (uint8 results
exact, float32 within 1e-6), and the synthetic and folder datasets equal."""
import random

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
import paddle_tpu.vision.datasets as jds
import paddle_tpu.vision.transforms as JT

import paddle_tpu_torch as ptt
import paddle_tpu_torch.vision.datasets as tds
import paddle_tpu_torch.vision.transforms as TT

F32_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _img(shape=(20, 28, 3), dtype=np.uint8, seed=0):
    r = np.random.RandomState(seed)
    if dtype == np.uint8:
        return r.randint(0, 256, shape, dtype=np.uint8)
    return (r.rand(*shape) * 255).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, paddle.Tensor):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _same(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
    if g.dtype == np.uint8 or np.issubdtype(g.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_ATOL * max(1.0, np.abs(w).max()))


U8, F32, GRAY = _img(), _img(dtype=np.float32), _img((20, 28))
PTS = ([[0, 0], [27, 0], [27, 19], [0, 19]], [[2, 1], [25, 3], [26, 18], [1, 17]])

FUNCTIONAL = {
    "to_tensor_u8": ("to_tensor", (U8,), {}),
    "to_tensor_hwc_gray": ("to_tensor", (GRAY,), {"data_format": "HWC"}),
    "normalize_hwc": ("normalize", (U8, [120.0, 110.0, 100.0], [60.0, 55.0, 50.0]),
                      {"data_format": "HWC"}),
    "normalize_chw": ("normalize", (np.transpose(F32, (2, 0, 1)), [0.5, 0.4, 0.3], [0.2, 0.3, 0.4]),
                      {}),
    "hflip": ("hflip", (U8,), {}),
    "hflip_gray": ("hflip", (GRAY,), {}),
    "vflip": ("vflip", (U8,), {}),
    "resize_int": ("resize", (U8, 11), {}),
    "resize_tuple_f32": ("resize", (F32, (33, 17)), {}),
    "resize_nearest": ("resize", (U8, (9, 40)), {"interpolation": "nearest"}),
    "resize_gray": ("resize", (GRAY, 14), {}),
    "crop": ("crop", (U8, 3, 5, 10, 12), {}),
    "center_crop": ("center_crop", (U8, 15), {}),
    "pad_int": ("pad", (U8, 3), {"fill": 7}),
    "pad_pair_reflect": ("pad", (U8, (2, 4)), {"padding_mode": "reflect"}),
    "pad_four_edge": ("pad", (F32, (1, 2, 3, 4)), {"padding_mode": "edge"}),
    "pad_symmetric": ("pad", (GRAY, (2, 1, 0, 3)), {"padding_mode": "symmetric"}),
    "brightness": ("adjust_brightness", (U8, 1.3), {}),
    "brightness_f32": ("adjust_brightness", (F32, 0.7), {}),
    "contrast": ("adjust_contrast", (U8, 0.6), {}),
    "saturation": ("adjust_saturation", (U8, 1.7), {}),
    "hue": ("adjust_hue", (U8, 0.2), {}),
    "hue_f32": ("adjust_hue", (F32, -0.35), {}),
    "rotate": ("rotate", (U8, 30), {}),
    "rotate_expand": ("rotate", (U8, -47.5), {"expand": True, "fill": 3}),
    "rotate_center": ("rotate", (F32, 12), {"center": (4, 6)}),
    "grayscale": ("to_grayscale", (U8,), {}),
    "grayscale3": ("to_grayscale", (F32, 3), {}),
    "affine": ("affine", (U8, 15, (2, -3), 1.1, (5.0, -4.0)), {"fill": 9}),
    "affine_scalar_shear": ("affine", (F32, -20, (0, 1), 0.9, 8.0), {"center": (10, 5)}),
    "perspective": ("perspective", (U8,) + PTS, {}),
    "erase_array": ("erase", (U8, 2, 3, 5, 6, 0), {}),
    "erase_array_values": ("erase", (F32, 1, 1, 4, 4, np.array([1.0, 2.0, 3.0], np.float32)), {}),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONAL))
def test_functional_matches_jax(case):
    name, args, kw = FUNCTIONAL[case]
    _same(getattr(TT.functional, name)(*args, **kw), getattr(JT.functional, name)(*args, **kw))


def test_tensor_image_ops_match_jax():
    """A tensor image: erase (CHW, out of place and in place) and normalize
    stay tensors, computed where they lie, equal to the JAX package's."""
    chw = np.transpose(F32, (2, 0, 1)).copy()
    t, j = torch.from_numpy(chw.copy()), paddle.to_tensor(chw.copy())
    _same(TT.functional.erase(t, 1, 2, 5, 4, 0.5), JT.functional.erase(j, 1, 2, 5, 4, 0.5))
    assert np.array_equal(t.numpy(), chw)
    out = TT.functional.erase(t, 0, 0, 3, 3, torch.tensor([1.0, 2.0, 3.0]).view(3, 1, 1),
                              inplace=True)
    ref = JT.functional.erase(j, 0, 0, 3, 3, paddle.to_tensor(
        np.array([1.0, 2.0, 3.0], np.float32).reshape(3, 1, 1)), inplace=True)
    assert out is t
    _same(t, ref)
    norm = TT.functional.normalize(t, [1.0, 2.0, 3.0], [2.0, 2.0, 2.0])
    assert isinstance(norm, torch.Tensor)
    _same(norm, JT.functional.normalize(ref, [1.0, 2.0, 3.0], [2.0, 2.0, 2.0]))


def _transforms(T):
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    return {
        "compose_paddleclas_train": T.Compose([T.RandomResizedCrop(16), T.RandomHorizontalFlip(),
                                               T.Normalize(mean, std, data_format="HWC"),
                                               T.Transpose()]),
        "to_tensor": T.ToTensor(),
        "normalize_scalar": T.Normalize(0.5, 0.25, data_format="HWC"),
        "resize": T.Resize((12, 30)),
        "resize_nearest": T.Resize(8, interpolation="nearest"),
        "hflip": T.RandomHorizontalFlip(0.5),
        "vflip": T.RandomVerticalFlip(0.5),
        "center_crop": T.CenterCrop((10, 14)),
        "random_crop": T.RandomCrop(12),
        "random_crop_padded": T.RandomCrop((24, 30), padding=2, pad_if_needed=True, fill=1),
        "random_resized_crop": T.RandomResizedCrop((14, 9), scale=(0.2, 0.9)),
        "random_resized_crop_fallback": T.RandomResizedCrop(6, scale=(2.0, 3.0)),
        "random_rotation": T.RandomRotation(25, fill=5),
        "color_jitter": T.ColorJitter(0.4, 0.4, 0.4, 0.1),
        "grayscale": T.Grayscale(3),
        "pad": T.Pad((1, 2), padding_mode="edge"),
        "transpose": T.Transpose(),
        "random_erasing": T.RandomErasing(prob=1.0, value=7),
        "random_erasing_chw": T.Compose([T.Transpose(), T.RandomErasing(prob=0.9)]),
        "brightness": T.BrightnessTransform(0.5),
        "contrast": T.ContrastTransform(0.5),
        "saturation": T.SaturationTransform(0.5),
        "hue": T.HueTransform(0.3),
        "random_affine": T.RandomAffine(20, translate=(0.1, 0.2), scale=(0.8, 1.2),
                                        shear=(-5, 5, -3, 3), fill=2),
        "random_affine_shear": T.RandomAffine(10, shear=6),
        "random_perspective": T.RandomPerspective(prob=1.0, distortion_scale=0.4),
    }


@pytest.mark.parametrize("case", sorted(_transforms(TT)))
def test_transform_classes_match_jax(case):
    """Each class on four images under one random.seed and np.random.seed:
    the same draws (crops, flips, angles, factors) and the same pixels."""
    outs = []
    for T in (TT, JT):
        random.seed(5)
        np.random.seed(5)
        t = _transforms(T)[case]
        outs.append([t(_img(seed=s)) for s in range(4)])
    for g, w in zip(*outs):
        _same(g, w)


def test_every_public_transform_name_is_ported():
    names = {n for n in dir(JT) if not n.startswith("_")}
    assert names <= {n for n in dir(TT) if not n.startswith("_")}
    assert len([n for n in dir(JT.transforms) if isinstance(getattr(JT.transforms, n), type)
                and n not in ("annotations",)]) >= 22


DATASETS = [("MNIST", {}), ("FashionMNIST", {"mode": "test"}), ("Cifar10", {}),
            ("Cifar100", {"mode": "test"}), ("Flowers", {}), ("VOC2012", {"mode": "valid"})]


@pytest.mark.parametrize("name,kw", DATASETS, ids=[d[0] for d in DATASETS])
def test_synthetic_datasets_equal_jax(name, kw):
    t, j = getattr(tds, name)(**kw), getattr(jds, name)(**kw)
    assert len(t) == len(j)
    assert np.array_equal(t.images, j.images) and np.array_equal(t.labels, j.labels)
    for i in (0, len(t) - 1):
        for a, b in zip(t[i], j[i]):
            _same(a, b)
    tt = getattr(tds, name)(transform=TT.Transpose(), **kw)
    assert tt[3][0].shape[0] in (1, 3)


def test_folder_datasets_equal_jax(tmp_path):
    for c, n in (("cat", 2), ("dog", 3)):
        (tmp_path / c).mkdir()
        for i in range(n):
            np.save(tmp_path / c / f"{i}.npy", _img((4, 5, 3), seed=10 * n + i))
    (tmp_path / "dog" / "notes.txt").write_text("skipped")
    t, j = tds.DatasetFolder(str(tmp_path)), jds.DatasetFolder(str(tmp_path))
    assert t.classes == j.classes and t.samples == j.samples and len(t) == 5
    for i in range(len(t)):
        _same(t[i][0], j[i][0])
        assert t[i][1] == j[i][1]
    ti, ji = tds.ImageFolder(str(tmp_path), transform=TT.Transpose()), jds.ImageFolder(
        str(tmp_path), transform=JT.Transpose())
    assert ti.samples == ji.samples
    _same(ti[4][0], ji[4][0])
    with pytest.raises(FileNotFoundError):
        tds.MNIST(image_path=str(tmp_path / "missing.gz"), label_path=str(tmp_path / "x.gz"))
