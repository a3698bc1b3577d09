"""The port's host-side preprocessing (``paddle_lite_tpu_torch.cv`` over its
copy of ``native/cv.cc``) against the reference binding, byte for byte.

Both build the same C++ with the same ``g++`` flags, so every output is
held equal, bit for bit (``to_tensor``'s float32 too), on seeded images of
odd and even sizes: NV12 and NV21, BGR↔RGB, bilinear resize up and down,
rotation by 90 / 180 / 270, flips on 0 / 1 / −1, and ``to_tensor`` with
ImageNet's mean and std; the argument checks raise as the reference's do.
"""

import numpy as np
import pytest

from paddle_lite_tpu import cv as r_cv
from paddle_lite_tpu_torch import cv
from paddle_lite_tpu_torch.native import build

SIZES = [(1, 1), (2, 2), (4, 6), (5, 7), (17, 31), (64, 48), (121, 223)]
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _img(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_the_library_is_the_ports_own_build():
    lib = build.build_library("cv")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libcv-")


@pytest.mark.parametrize("nv21", [False, True])
@pytest.mark.parametrize("h,w", [(2, 2), (4, 6), (6, 10), (16, 30), (120, 222)])
def test_nv_to_rgb(h, w, nv21):
    rng = np.random.default_rng(h * w + nv21)
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), dtype=np.uint8)
    _same(cv.nv_to_rgb(y, uv, h, w, nv21=nv21), r_cv.nv_to_rgb(y, uv, h, w, nv21=nv21))


@pytest.mark.parametrize("h,w", SIZES)
def test_bgr_to_rgb(h, w):
    img = _img(h, w, seed=h + w)
    _same(cv.bgr_to_rgb(img), r_cv.bgr_to_rgb(img))


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("h,w,oh,ow", [(5, 7, 3, 2), (17, 31, 224, 224), (121, 223, 32, 96),
                                       (64, 48, 64, 48), (2, 2, 9, 5)])
def test_resize(h, w, oh, ow, c):
    img = _img(h, w, c, seed=oh * ow + c)
    _same(cv.resize(img, oh, ow), r_cv.resize(img, oh, ow))


@pytest.mark.parametrize("degree", [90, 180, 270])
@pytest.mark.parametrize("h,w", SIZES)
def test_rotate(h, w, degree):
    img = _img(h, w, seed=degree + h)
    _same(cv.rotate(img, degree), r_cv.rotate(img, degree))


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("h,w", SIZES)
def test_flip(h, w, axis):
    img = _img(h, w, seed=axis + 7 * w)
    _same(cv.flip(img, axis), r_cv.flip(img, axis))


@pytest.mark.parametrize("mean,std", [(MEAN, STD), ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
                                      ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))])
@pytest.mark.parametrize("h,w", SIZES)
def test_to_tensor(h, w, mean, std):
    img = _img(h, w, seed=3 * h + w)
    _same(cv.to_tensor(img, mean, std), r_cv.to_tensor(img, mean, std))


def test_the_serving_pipeline_is_the_reference():
    """NV12 720p → RGB → 224² → normalized (``examples/serve_classifier.py``)."""
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (720, 1280), dtype=np.uint8)
    uv = rng.integers(0, 256, (360, 1280), dtype=np.uint8)
    out = cv.to_tensor(cv.resize(cv.nv_to_rgb(y, uv, 720, 1280), 224, 224), MEAN, STD)
    ref = r_cv.to_tensor(r_cv.resize(r_cv.nv_to_rgb(y, uv, 720, 1280), 224, 224), MEAN, STD)
    _same(out, ref)


@pytest.mark.parametrize("degree", [0, 45, 360, -90])
def test_rotate_checks_the_degree(degree):
    img = _img(3, 4)
    for mod in (cv, r_cv):
        with pytest.raises(ValueError, match="degree"):
            mod.rotate(img, degree)


@pytest.mark.parametrize("c,mean", [(1, MEAN), (4, MEAN), (3, (0.5, 0.5))])
def test_to_tensor_checks_the_channels(c, mean):
    img = _img(3, 4, c)
    for mod in (cv, r_cv):
        with pytest.raises(ValueError, match="entries"):
            mod.to_tensor(img, mean, STD if len(mean) == 3 else (1.0, 1.0))
