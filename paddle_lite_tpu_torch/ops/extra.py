"""Op names a fluid import reaches beyond the core families: the QAT
fake-quant ops, ``flatten_contiguous_range``, the paddle 2.x interp names
``nearest_interp_v2`` / ``bilinear_interp_v2``, the unary ops ``erf``,
``sign``, ``ceil``, ``round``, ``sin``, ``cos``, and ``reduce_all`` /
``reduce_any``.

Port of the parts of ``paddle_lite_tpu/ops/extra.py`` that
``formats/fluid_convert.py`` can emit (``:24-45``, ``:170-203``,
``:253-289``); the rest of that module is later work (``ROADMAP.md``).
None of them reads a value back to the host.

``bilinear_interp_v2`` is bilinear here.  The reference registers its
``interp_xla`` for the name, which picks bilinear for ``bilinear_interp``
only, so its ``_v2`` resizes by nearest (a fault there, ``ROADMAP.md`` §3).

The QAT fake ops take the ``input_slots`` the reference gives them
(``InScale`` / ``Scales``), which ``quant.quantize_pass.quant_dequant_fuse``
reads when it deletes them during ``optimize()``.  Before that they compute
what the training graph computed, a quantize-dequantize round trip in fp32,
so an unoptimized QAT import still runs and can be compared with the fused
int8 program.
"""

from __future__ import annotations

import torch

from ..core.registry import OPS
from .common import f32
from .manip import _interp_shape, interp_torch, reduce_impl, reshape_torch


def _same(attrs, in_shapes):
    return [in_shapes[0]]


# ---- paddle 2.x names -----------------------------------------------------

for _name in ("nearest_interp_v2", "bilinear_interp_v2"):
    OPS.register(_name, infer_shape=_interp_shape)
    OPS.get(_name).impls["torch"] = interp_torch


@OPS.shape_fn("flatten_contiguous_range")
def flatten_range_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    start = int(attrs.get("start_axis", 1)) % len(x)
    stop = int(attrs.get("stop_axis", -1)) % len(x)
    mid = 1
    for d in x[start:stop + 1]:
        mid *= int(d)
    return [tuple(x[:start] + [mid] + x[stop + 1:])]


OPS.get("flatten_contiguous_range").impls["torch"] = reshape_torch


# ---- unary ops --------------------------------------------------------------

UNARY = {"erf": torch.erf, "sign": torch.sign, "ceil": torch.ceil,
         "round": torch.round,  # half to even, as jnp.round
         "sin": torch.sin, "cos": torch.cos}


def _unary(fn):
    def impl(ctx, op, ins):
        return {"Out": [fn(ins["X"][0])]}

    return impl


for _name, _fn in UNARY.items():
    OPS.register(_name, infer_shape=_same)
    OPS.get(_name).impls["torch"] = _unary(_fn)


# ---- reduce_all / reduce_any --------------------------------------------------

def _all(x, dims, keep):
    return torch.all(x, dim=dims, keepdim=keep).to(torch.bool)


def _any(x, dims, keep):
    return torch.any(x, dim=dims, keepdim=keep).to(torch.bool)


for _name, _fn in (("reduce_all", _all), ("reduce_any", _any)):
    OPS.register(_name, infer_shape=OPS.get("reduce_mean").infer_shape)
    OPS.get(_name).impls["torch"] = reduce_impl(_fn)


# ---- QAT fake-quant ops (PaddleSlim graphs) -------------------------------------

FAKE_QUANT = ("fake_quantize_abs_max",
              "fake_quantize_range_abs_max",
              "fake_quantize_moving_average_abs_max",
              "fake_quantize_dequantize_moving_average_abs_max",
              "fake_quantize_dequantize_abs_max")
FAKE_DEQUANT = ("fake_dequantize_max_abs", "fake_channel_wise_dequantize_max_abs")


def fake_quant_torch(ctx, op, ins):
    """``round(x / r · qmax)`` clipped to ±qmax, times ``r / qmax``, with
    ``r`` the recorded threshold: the ``InScale`` input, else the ``scale``
    attr, else the input's abs-max; at least 1e-10."""
    x = ins["X"][0]
    qmax = f32(2 ** (int(op.attrs.get("bit_length", 8)) - 1) - 1, x.device)
    if "InScale" in ins:
        r = torch.abs(ins["InScale"][0]).reshape(())
    elif "scale" in op.attrs:
        r = f32(op.attrs["scale"], x.device)
    else:
        r = torch.amax(torch.abs(x))  # abs_max variant: dynamic range
    r = torch.clamp_min(r.to(torch.float32), f32(1e-10, x.device))
    q = torch.clamp(torch.round(x / r * qmax), -qmax, qmax)
    return {"Out": [q * (r / qmax)]}


def fake_dequant_torch(ctx, op, ins):
    """The paired fake_quantize already gave dequantized values."""
    return {"Out": [ins["X"][0]]}


for _name in FAKE_QUANT:
    OPS.register(_name, infer_shape=_same, input_slots=("X", "InScale"))
    OPS.get(_name).impls["torch"] = fake_quant_torch

for _name in FAKE_DEQUANT:
    OPS.register(_name, infer_shape=_same, input_slots=("X", "Scales"))
    OPS.get(_name).impls["torch"] = fake_dequant_torch
