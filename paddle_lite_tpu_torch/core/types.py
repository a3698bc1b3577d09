"""Type system — analog of Paddle-Lite's ``lite/core/type_system.{h,cc}``.

Copy of ``paddle_lite_tpu/core/types.py`` with one change: precisions map to
torch dtypes (``Precision.torch_dtype``) instead of the jnp bfloat16 numpy
dtype (``core/types.py:37-41`` there).  The surviving axis of the
reference's (target, precision, layout) triple is *precision*; the layout is
NHWC activations / HWIO filters at every public function, as in the JAX
package.  The precision tags on graph variables drive the quantize
insertion pass (the reference's ``type_precision_cast_pass``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch


class Precision(enum.Enum):
    """Analog of Paddle-Lite's ``PrecisionType`` (lite/api/paddle_place.h)."""

    FP32 = "fp32"
    BF16 = "bf16"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    BOOL = "bool"
    FP16 = "fp16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {
            Precision.FP32: torch.float32,
            Precision.BF16: torch.bfloat16,
            Precision.INT8: torch.int8,
            Precision.INT16: torch.int16,
            Precision.INT32: torch.int32,
            Precision.INT64: torch.int64,
            Precision.BOOL: torch.bool,
            Precision.FP16: torch.float16,
        }[self]


class DataLayout(enum.Enum):
    """Analog of ``DataLayoutType``; NHWC is canonical, as in the reference.

    Ops that call torch's NCHW convolutions permute inside the op.
    """

    NHWC = "nhwc"
    NCHW = "nchw"  # only used transiently by the weight importer
    ANY = "any"


class CalibMethod(enum.Enum):
    """Activation-range calibration methods (PTQ).

    The reference consumes scales computed offline by PaddleSlim
    (abs-max / moving-average-abs-max / KL); here calibration is built in.
    """

    ABS_MAX = "abs_max"
    MOVING_AVERAGE_ABS_MAX = "moving_average_abs_max"
    PERCENTILE = "percentile"
    ENTROPY = "entropy"  # KL-divergence based, a la TensorRT/PaddleSlim


@dataclasses.dataclass(frozen=True)
class QuantInfo:
    """Quantization metadata attached to a graph variable.

    Mirrors the ``input_scale`` / ``weight_scale`` attributes that
    Paddle-Lite's ``quant_dequant_fuse_pass`` stamps onto conv/fc/mul ops
    (lite/core/mir/fusion/quant_dequant_op_fuser.cc), normalized into a
    per-variable record:

    - weights: symmetric per-channel int8, ``axis`` = output-channel axis,
      ``scale`` has one entry per channel.
    - activations: symmetric per-tensor int8, scalar ``scale``.

    ``q = clip(round(x / scale), -127, 127)``; dequant is ``x ≈ q * scale``.
    """

    scale: Tuple[float, ...]  # length 1 => per-tensor
    axis: Optional[int] = None  # None => per-tensor
    bits: int = 8
    symmetric: bool = True
    # W4 storage (bits=4): two 4-bit values packed per int8 byte along this
    # axis (element 2i in the low nibble, 2i+1 in the high); None for
    # unpacked storage.  The jnp int4 dtype is broken in this jax build
    # (RecursionError), so 4-bit weights ride int8 containers and the op
    # impls unpack with shift/mask ops (ops/common._unpack_w4).
    pack_axis: Optional[int] = None

    @property
    def per_channel(self) -> bool:
        return self.axis is not None

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1  # 127 for int8

    def scale_array(self) -> np.ndarray:
        return np.asarray(self.scale, dtype=np.float32)

    @staticmethod
    def per_tensor(scale: float, bits: int = 8) -> "QuantInfo":
        return QuantInfo(scale=(float(scale),), axis=None, bits=bits)

    @staticmethod
    def per_channel_scales(scales, axis: int, bits: int = 8) -> "QuantInfo":
        return QuantInfo(
            scale=tuple(float(s) for s in np.asarray(scales).reshape(-1)),
            axis=axis,
            bits=bits,
        )


@dataclasses.dataclass(frozen=True)
class TensorType:
    """(precision, layout) pair — the surviving part of the reference's
    ``Type`` triple used for cast-insertion compatibility checks
    (lite/core/type_system.h ``PrecisionCompatibleTo``)."""

    precision: Precision = Precision.FP32
    layout: DataLayout = DataLayout.NHWC

    def compatible_with(self, other: "TensorType") -> bool:
        prec_ok = (
            self.precision == other.precision
            or Precision.FP32 in (self.precision, other.precision)
            and Precision.BF16 in (self.precision, other.precision)
        )
        layout_ok = (
            DataLayout.ANY in (self.layout, other.layout)
            or self.layout == other.layout
        )
        return prec_ok and layout_ok
