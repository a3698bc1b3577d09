"""Plain int8 arithmetic of the benchmark's transformer configurations.

The counterpart of :mod:`.qref` for token inputs: a configuration's
reference (``reference/<config>.py``) writes its model once as
``forward(be, cfg, p, x)`` over a backend ``be`` and runs it twice:

- :class:`Float32` runs it in float32 with TF32 off and records the abs-max
  of every activation the int8 scheme quantizes: each tensor handed to
  :meth:`Float32.quant` (a quantize op before an ``fc``), each ``fc`` output
  marked ``requant`` and each attention's ``P·V`` output (the calibration);
- :class:`Quantized` runs it with ``bits``-bit symmetric quantization (8 for
  the configurations, 4 for the control): per-output-channel abs-max weights
  (:func:`.qref.quantize_weight`), per-tensor activation scales ``abs-max /
  (2^(bits-1) - 1)`` from the calibration, exact integer sums in float64,
  then ``acc * s_x * s_w[c] + bias -> act`` and, where marked, a requant.

Everything else (embedding lookups, layer norms, residual adds, the
attention's ``Q·Kᵀ``, softmax and ``P·V``) is float: float32 in
:class:`Float32`, float64 in :class:`Quantized`.

Plain PyTorch only: nothing here imports the program or JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .qref import Act, qmax, quantize_weight, tf32_off


def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "tanh":
        return torch.tanh(y)
    raise ValueError(f"activation {act!r} is not in the reference")


class _Float:
    """What both passes compute alike, in ``self.dtype``."""

    dtype = torch.float32

    def embed(self, tables: List[torch.Tensor], ids: List[torch.Tensor],
              positions: torch.Tensor) -> Act:
        """The sum of each table's rows at its ids, plus the position rows
        (``positions``: (T, H), the same for every sequence)."""
        y = positions.to(self.dtype)
        for t, i in zip(tables, ids):
            y = y + t[i.long()].to(self.dtype)
        return Act(y)

    def layer_norm(self, x: Act, gb, eps: float) -> Act:
        g, b = gb
        return Act(F.layer_norm(x.real(), (x.value.shape[-1],), g.to(self.dtype),
                                b.to(self.dtype), eps))

    def add(self, x: Act, y: Act) -> Act:
        return Act(x.real() + y.real())

    def first(self, x: Act) -> Act:
        """The first position of each sequence."""
        return Act(x.value[:, 0], x.scale)

    @staticmethod
    def _pv(x: Act, heads: int) -> torch.Tensor:
        """softmax(Q·Kᵀ / sqrt(d)) · V of each head, its heads side by side
        again, from the fused (n, T, 3H) projection."""
        n, t, h3 = x.value.shape
        d = h3 // 3 // heads
        q, k, v = (z.reshape(n, t, heads, d).transpose(1, 2)
                   for z in x.real().split(h3 // 3, dim=-1))
        p = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d)), dim=-1)
        return (p @ v).transpose(1, 2).reshape(n, t, h3 // 3)


class Float32(_Float):
    """The float model with TF32 off; records the abs-max of each quantized
    activation (``amax[i]`` for the i-th, in call order), the maximum over
    calls of :meth:`run`."""

    def __init__(self):
        self.amax: Dict[int, float] = {}
        self._i = 0

    def _record(self, y: torch.Tensor) -> None:
        self.amax[self._i] = max(self.amax.get(self._i, 0.0), float(y.abs().amax()))
        self._i += 1

    def run(self, forward, p, x: torch.Tensor) -> torch.Tensor:
        self._i = 0
        with tf32_off():
            return forward(self, p, x).value

    def quant(self, x: Act) -> Act:
        self._record(x.value)
        return x

    def fc(self, x: Act, wb, act: Optional[str] = None, requant: bool = False) -> Act:
        w, b = wb
        y = _act(x.value @ w + b, act)
        if requant:
            self._record(y)
        return Act(y)

    def attention(self, qkv: Act, heads: int) -> Act:
        y = self._pv(qkv, heads)
        self._record(y)
        return Act(y)


class Quantized(_Float):
    """The model at ``bits`` bits from a calibration's abs-maxes; every sum
    of integer products is exact in float64."""

    dtype = torch.float64

    def __init__(self, amax: Dict[int, float], bits: int = 8):
        self.amax, self.bits = amax, bits
        self._wq: Dict[int, tuple] = {}
        self._i = 0

    def run(self, forward, p, x: torch.Tensor) -> torch.Tensor:
        self._i = 0
        return forward(self, p, x).value

    def _requant(self, y: torch.Tensor) -> Act:
        s = max(self.amax[self._i], 1e-10) / qmax(self.bits)
        self._i += 1
        return Act(torch.clamp(torch.round(y / s), -qmax(self.bits), qmax(self.bits)), s)

    def _weight(self, w: torch.Tensor):
        key = id(w)
        if key not in self._wq:
            self._wq[key] = (w,) + quantize_weight(w, self.bits)
        return self._wq[key][1:]

    def quant(self, x: Act) -> Act:
        return self._requant(x.real())

    def fc(self, x: Act, wb, act: Optional[str] = None, requant: bool = False) -> Act:
        if x.scale is None:
            raise ValueError("an fc's input is quantized first (quant, or a requant)")
        w, b = wb
        wq, sw = self._weight(w)
        y = _act((x.value @ wq) * (x.scale * sw) + b.to(torch.float64), act)
        return self._requant(y) if requant else Act(y)

    def attention(self, qkv: Act, heads: int) -> Act:
        return self._requant(self._pv(qkv, heads))


class Reference:
    """One configuration's reference, prepared from the raw float32 weights
    (name -> tensor, as ``params(cfg)`` lists them) and the calibration
    batches of ids: weights folded, abs-maxes calibrated.  ``__call__``
    gives float64 softmax probabilities at ``bits`` bits; :meth:`float`
    the float32 model's."""

    def __init__(self, model, cfg: dict, raw: Dict[str, torch.Tensor],
                 calib: List[torch.Tensor]):
        self.model, self.cfg = model, cfg
        self.p = model.fold(cfg, raw)
        f32 = Float32()
        for x in calib:
            f32.run(self._forward, self.p, x)
        self.amax = f32.amax

    def _forward(self, be, p, x: torch.Tensor) -> Act:
        return self.model.forward(be, self.cfg, p, x)

    def float(self, x: torch.Tensor) -> torch.Tensor:
        logits = Float32().run(self._forward, self.p, x)
        return torch.softmax(logits.to(torch.float64), dim=-1)

    def __call__(self, x: torch.Tensor, bits: int = 8) -> torch.Tensor:
        logits = Quantized(self.amax, bits).run(self._forward, self.p, x)
        return torch.softmax(logits.to(torch.float64), dim=-1)
