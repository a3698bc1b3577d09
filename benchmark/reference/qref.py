"""Plain int8 arithmetic of the benchmark's CNN configurations.

A configuration's reference (``reference/<config>.py``) writes its model once
as ``forward(be, p, x)`` over a backend ``be`` and runs it twice:

- :class:`Float32` runs it in float32 with TF32 off, batch norms folded, and
  records the abs-max of every conv's output: the calibration
  (:class:`DataInit`, a variant of it, sets the seeded weights' batch norms
  from the calibration images before either side sees them);
- :class:`Quantized` runs it with ``bits``-bit symmetric quantization (8 for
  the configurations, 4 for the control): per-output-channel abs-max weights,
  per-tensor activation scales ``abs-max / (2^(bits-1) - 1)`` from the
  calibration, exact integer sums in float64, then ``acc * s_x * s_w[c] +
  bias (+ residual) -> act`` and a requant of every conv's output.

The quantization scheme is the one each configuration's file states: the stem
conv stays float (its input is the image) and its output is requantized; a
pool passes int8 levels on at its input's scale (the average rounded half to
even); the classifier's output stays float and feeds a float64 softmax.

Plain PyTorch only: nothing here imports the program or JAX.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32_off():
    """Full float32 matmuls and convs (cuDNN would use TF32 on Hopper)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fold_bn(w: torch.Tensor, gamma, beta, mean, var, eps: float = 1e-5):
    """(HWIO weight, bias) with the batch norm folded in, in float32."""
    inv = gamma / torch.sqrt(var + eps)
    return w * inv, beta - mean * inv


def qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def quantize_weight(w: torch.Tensor, bits: int):
    """Per-output-channel (last axis) symmetric quantization: integer levels
    and scales, both float64."""
    w = w.to(torch.float64)
    amax = w.abs().reshape(-1, w.shape[-1]).amax(dim=0).clamp_min(1e-10)
    s = amax / qmax(bits)
    return torch.clamp(torch.round(w / s), -qmax(bits), qmax(bits)), s


class Act:
    """An activation: float values, or integer levels at ``scale``."""

    def __init__(self, value: torch.Tensor, scale: Optional[float] = None):
        self.value, self.scale = value, scale

    def real(self) -> torch.Tensor:
        return self.value if self.scale is None else self.value * self.scale


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int, pad: int,
          groups: int) -> torch.Tensor:
    """NHWC x HWIO -> NHWC, in the dtype of the operands."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)


def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    raise ValueError(f"activation {act!r} is not in the reference")


class Float32:
    """The float model with TF32 off; records each conv output's abs-max
    (``amax[i]`` for the i-th conv call), the maximum over calls of
    :meth:`run`."""

    def __init__(self):
        self.amax: Dict[int, float] = {}
        self._i = 0

    def run(self, forward, p, x: torch.Tensor) -> torch.Tensor:
        self._i = 0
        with tf32_off():
            return forward(self, p, Act(x.to(torch.float32))).value

    def conv(self, x: Act, wb, stride: int = 1, pad: int = 0, groups: int = 1,
             act: Optional[str] = None, residual: Optional[Act] = None) -> Act:
        w, b = wb
        y = _conv(x.value, w, stride, pad, groups) + b
        if residual is not None:
            y = y + residual.value
        y = _act(y, act)
        a = float(y.abs().amax())
        self.amax[self._i] = max(self.amax.get(self._i, 0.0), a)
        self._i += 1
        return Act(y)

    def maxpool(self, x: Act, k: int, stride: int, pad: int) -> Act:
        return Act(_maxpool(x.value, k, stride, pad))

    def avgpool(self, x: Act) -> Act:
        return Act(x.value.mean(dim=(1, 2)))

    def fc(self, x: Act, wb) -> Act:
        w, b = wb
        return Act(x.value @ w + b)


class DataInit(Float32):
    """Sets each batch norm's mean and variance from the data, layer by
    layer in one float32 pass over a batch, as data-dependent
    initialisation does.  Run it on ``{conv: conv name}`` for ``p`` (the
    classifier ``(w, b)`` as usual): each conv's raw output ``y`` over the
    batch gives its per-channel mean ``m`` and variance ``v``, and the
    batch norm gets ``mean = centre * m`` and ``var = v + ((1 - centre) *
    m)^2``, so the normalised output has unit mean square about its kept
    mean.  ``gamma_scale`` multiplies the scale of the batch norms whose
    conv name ends with a key (a residual branch's last, kept small as a
    trained network's is).  The weights in ``raw`` are changed in place."""

    def __init__(self, raw: Dict[str, torch.Tensor], centre: float,
                 gamma_scale: Optional[Dict[str, float]] = None):
        super().__init__()
        self.raw, self.centre = raw, centre
        self.gamma_scale = gamma_scale or {}

    def conv(self, x: Act, wb, stride: int = 1, pad: int = 0, groups: int = 1,
             act: Optional[str] = None, residual: Optional[Act] = None) -> Act:
        raw, name = self.raw, wb
        y = _conv(x.value, raw[f"{name}.w"], stride, pad, groups)
        m, v = y.mean(dim=(0, 1, 2)), y.var(dim=(0, 1, 2))
        raw[f"{name}.bn.mean"] = self.centre * m
        raw[f"{name}.bn.var"] = v + ((1.0 - self.centre) * m) ** 2
        for suffix, k in self.gamma_scale.items():
            if name.endswith(suffix):
                raw[f"{name}.bn.gamma"] = raw[f"{name}.bn.gamma"] * k
        wb = fold_bn(raw[f"{name}.w"], *(raw[f"{name}.bn.{k}"]
                                         for k in ("gamma", "beta", "mean", "var")))
        return super().conv(x, wb, stride, pad, groups, act, residual)


def _maxpool(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, pad)
    return y.permute(0, 2, 3, 1)


class Quantized:
    """The model at ``bits`` bits from a calibration's abs-maxes; every sum
    of integer products is exact in float64."""

    def __init__(self, amax: Dict[int, float], bits: int = 8):
        self.amax, self.bits = amax, bits
        self._wq: Dict[int, tuple] = {}
        self._i = 0

    def run(self, forward, p, x: torch.Tensor) -> torch.Tensor:
        self._i = 0
        return forward(self, p, Act(x.to(torch.float64))).value

    def _weight(self, w: torch.Tensor):
        key = id(w)
        if key not in self._wq:
            self._wq[key] = (w,) + quantize_weight(w, self.bits)
        return self._wq[key][1:]

    def conv(self, x: Act, wb, stride: int = 1, pad: int = 0, groups: int = 1,
             act: Optional[str] = None, residual: Optional[Act] = None) -> Act:
        w, b = wb
        if x.scale is None:  # the stem: a float conv of the image
            y = _conv(x.value, w.to(torch.float64), stride, pad, groups)
        else:
            wq, sw = self._weight(w)
            y = _conv(x.value, wq, stride, pad, groups) * (x.scale * sw)
        y = y + b.to(torch.float64)
        if residual is not None:
            y = y + residual.real()
        y = _act(y, act)
        s = max(self.amax[self._i], 1e-10) / qmax(self.bits)
        self._i += 1
        return Act(torch.clamp(torch.round(y / s), -qmax(self.bits), qmax(self.bits)), s)

    def maxpool(self, x: Act, k: int, stride: int, pad: int) -> Act:
        return Act(_maxpool(x.value, k, stride, pad), x.scale)

    def avgpool(self, x: Act) -> Act:
        n = x.value.shape[1] * x.value.shape[2]
        mean = torch.round(x.value.sum(dim=(1, 2)) / n)
        return Act(torch.clamp(mean, -qmax(self.bits), qmax(self.bits)), x.scale)

    def fc(self, x: Act, wb) -> Act:
        w, b = wb
        wq, sw = self._weight(w)
        return Act((x.value @ wq) * (x.scale * sw) + b.to(torch.float64))


class Reference:
    """One configuration's reference, prepared from the raw float32 weights
    (name -> tensor, as ``params(cfg)`` lists them) and the calibration
    batches: batch norms folded, abs-maxes calibrated.  ``__call__`` gives
    float64 softmax probabilities at ``bits`` bits."""

    def __init__(self, model, cfg: dict, raw: Dict[str, torch.Tensor],
                 calib: List[torch.Tensor]):
        self.model, self.cfg = model, cfg
        self.p = model.fold(cfg, raw)
        f32 = Float32()
        for x in calib:
            f32.run(self._forward, self.p, x)
        self.amax = f32.amax

    def _forward(self, be, p, x: Act) -> Act:
        return self.model.forward(be, self.cfg, p, x)

    def __call__(self, x: torch.Tensor, bits: int = 8) -> torch.Tensor:
        logits = Quantized(self.amax, bits).run(self._forward, self.p, x)
        return torch.softmax(logits.to(torch.float64), dim=-1)
