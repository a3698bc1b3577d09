"""Image preprocessing — ctypes binding of the native CV library.

Port of ``paddle_lite_tpu/cv/preprocess.py`` over the port's own copy of
its C++ (``paddle_lite_tpu_torch/native/cv.cc``, built by ``native/build.py``
with ``g++`` into ``paddle_lite_tpu_torch/_build/``); the reference shipped
this as ``paddle_lite_cv`` (``lite/utils/cv/``).  The same functions, the
same argument checks and the same bytes out.  It runs on the host, ahead
of the card's feed, as the reference's does.

Typical serving pipeline: camera NV12 → RGB → resize → normalize →
NHWC float array, all on the host:

    rgb = nv_to_rgb(y, uv, h, w)
    rgb = resize(rgb, 224, 224)
    tensor = to_tensor(rgb, mean=(0.485, 0.456, 0.406),
                       std=(0.229, 0.224, 0.225))  # (224, 224, 3) f32
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from ..native.build import load_library


def _lib():
    lib = load_library("cv")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.cv_nv_to_rgb.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, u8p]
    lib.cv_bgr_rgb_swap.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    lib.cv_resize_bilinear.argtypes = [u8p] + [ctypes.c_int] * 5 + [u8p]
    lib.cv_rotate.argtypes = [u8p] + [ctypes.c_int] * 4 + [u8p]
    lib.cv_flip.argtypes = [u8p] + [ctypes.c_int] * 4 + [u8p]
    lib.cv_image_to_tensor.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, f32p, f32p, f32p]
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def nv_to_rgb(y: np.ndarray, uv: np.ndarray, height: int, width: int,
              nv21: bool = False) -> np.ndarray:
    y = np.ascontiguousarray(y, np.uint8).reshape(height, width)
    uv = np.ascontiguousarray(uv, np.uint8).reshape(height // 2, width)
    out = np.empty((height, width, 3), np.uint8)
    _lib().cv_nv_to_rgb(_u8(y), _u8(uv), height, width, int(nv21), _u8(out))
    return out


def bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    out = np.empty_like(img)
    _lib().cv_bgr_rgb_swap(_u8(img), h, w, _u8(out))
    return out


def resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    _lib().cv_resize_bilinear(_u8(img), h, w, c, out_h, out_w, _u8(out))
    return out


def rotate(img: np.ndarray, degree: int) -> np.ndarray:
    if degree not in (90, 180, 270):
        raise ValueError("degree must be 90/180/270")
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out_shape = (h, w, c) if degree == 180 else (w, h, c)
    out = np.empty(out_shape, np.uint8)
    _lib().cv_rotate(_u8(img), h, w, c, degree, _u8(out))
    return out


def flip(img: np.ndarray, axis: int) -> np.ndarray:
    """axis: 0 vertical, 1 horizontal, -1 both (reference flip convention)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty_like(img)
    _lib().cv_flip(_u8(img), h, w, c, axis, _u8(out))
    return out


def to_tensor(
    img: np.ndarray,
    mean: Sequence[float] = (0.0, 0.0, 0.0),
    std: Sequence[float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
    """uint8 HWC -> float32 HWC, (x/255 - mean)/std per channel (NHWC-ready)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    if mean_a.size != c or std_a.size != c:
        raise ValueError(f"mean/std must have {c} entries")
    out = np.empty((h, w, c), np.float32)
    _lib().cv_image_to_tensor(_u8(img), h, w, c, _f32(mean_a), _f32(std_a),
                              _f32(out))
    return out
