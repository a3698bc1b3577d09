"""Op names beyond the core families: the QAT fake-quant ops,
``flatten_contiguous_range``, the paddle 2.x names ``matmul_v2``,
``nearest_interp_v2`` / ``bilinear_interp_v2``, the unary ops ``erf``,
``sign``, ``ceil``, ``round``, ``sin``, ``cos``, ``reduce_all`` /
``reduce_any``, the norms ``group_norm`` / ``instance_norm``, and
``add_n`` / ``sum``, ``cumsum``, ``expand_as``, ``meshgrid``, ``one_hot``
/ ``one_hot_v2``, ``tile``, ``unstack`` and ``where``.

Port of ``paddle_lite_tpu/ops/extra.py``.  None of them reads a value back
to the host.  ``one_hot`` of an id outside [0, depth) gives a row of zeros,
as ``jax.nn.one_hot`` does (``F.one_hot`` would raise); integer ``cumsum``
stays in its dtype, as ``jnp.cumsum`` does (torch's promotes to int64).

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
from .nn import matmul_shape, matmul_torch


def _same(attrs, in_shapes):
    return [in_shapes[0]]


# ---- paddle 2.x names -----------------------------------------------------

OPS.register("matmul_v2", infer_shape=matmul_shape)
OPS.get("matmul_v2").impls["torch"] = matmul_torch

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


# ---- normalization variants (``extra.py:48-86`` there) ------------------------

def _norm_affine(y, ins):
    scale = ins.get("Scale", [None])[0]
    bias = ins.get("Bias", [None])[0]
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def _normalize(x, dims, eps):
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + f32(eps, x.device))


@OPS.shape_fn("group_norm")
def group_norm_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("group_norm", "torch")
def group_norm_torch(ctx, op, ins):
    """NHWC; statistics over (H, W, the group's channels), in float32."""
    x = ins["X"][0].to(torch.float32)
    groups = int(op.attrs.get("groups", 1))
    n, h, w, c = x.shape
    y = _normalize(x.reshape(n, h, w, groups, c // groups), (1, 2, 4),
                   op.attrs.get("epsilon", 1e-5)).reshape(n, h, w, c)
    return {"Y": [_norm_affine(y, ins)]}


@OPS.shape_fn("instance_norm")
def instance_norm_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("instance_norm", "torch")
def instance_norm_torch(ctx, op, ins):
    """NHWC; statistics over (H, W) of each channel, in float32."""
    y = _normalize(ins["X"][0].to(torch.float32), (1, 2), op.attrs.get("epsilon", 1e-5))
    return {"Y": [_norm_affine(y, ins)]}


# ---- misc tensor ops (``extra.py:113-151``, ``:206-250`` there) ------------------

@OPS.shape_fn("unstack")
def unstack_shape(attrs, in_shapes):
    x = list(in_shapes[0])
    axis = int(attrs.get("axis", 0)) % len(x)
    return [tuple(x[:axis] + x[axis + 1:])] * x[axis]


@OPS.kernel("unstack", "torch")
def unstack_torch(ctx, op, ins):
    x = ins["X"][0]
    return {"Y": list(torch.unbind(x, dim=int(op.attrs.get("axis", 0)) % x.ndim))}


@OPS.shape_fn("expand_as")
def expand_as_shape(attrs, in_shapes):
    return [in_shapes[1]]


@OPS.kernel("expand_as", "torch")
def expand_as_torch(ctx, op, ins):
    """``X`` broadcast to ``Y``'s shape (a view)."""
    return {"Out": [ins["X"][0].expand(ins["Y"][0].shape)]}


@OPS.shape_fn("tile")
def tile_shape(attrs, in_shapes):
    return [tuple(d * t for d, t in zip(in_shapes[0], attrs["repeat_times"]))]


@OPS.kernel("tile", "torch")
def tile_torch(ctx, op, ins):
    """``jnp.tile``: fewer repeats than axes repeat the trailing axes."""
    x = ins["X"][0]
    times = [int(t) for t in op.attrs["repeat_times"]]
    return {"Out": [x.repeat(*([1] * (x.ndim - len(times)) + times))]}


@OPS.shape_fn("add_n")
def add_n_shape(attrs, in_shapes):
    return [in_shapes[0]]


def add_n_torch(ctx, op, ins):
    """The inputs summed left to right."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


for _name in ("add_n", "sum"):
    OPS.register(_name, infer_shape=add_n_shape)
    OPS.get(_name).impls["torch"] = add_n_torch


@OPS.shape_fn("meshgrid")
def meshgrid_shape(attrs, in_shapes):
    dims = tuple(s[0] for s in in_shapes)
    return [dims] * len(in_shapes)


@OPS.kernel("meshgrid", "torch")
def meshgrid_torch(ctx, op, ins):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}


@OPS.shape_fn("where")
def where_shape(attrs, in_shapes):
    return [in_shapes[1]]


@OPS.kernel("where", "torch")
def where_torch(ctx, op, ins):
    return {"Out": [torch.where(ins["Condition"][0].to(torch.bool), ins["X"][0],
                                ins["Y"][0])]}


@OPS.shape_fn("cumsum")
def cumsum_shape(attrs, in_shapes):
    return [in_shapes[0]]


@OPS.kernel("cumsum", "torch")
def cumsum_torch(ctx, op, ins):
    """Along ``axis``; an integer sum stays in the input's dtype (a boolean
    one is int32), as ``jnp.cumsum`` gives it."""
    x = ins["X"][0]
    dtype = torch.int32 if x.dtype == torch.bool else x.dtype
    return {"Out": [torch.cumsum(x, dim=int(op.attrs.get("axis", -1)), dtype=dtype)]}


@OPS.shape_fn("one_hot")
def one_hot_shape(attrs, in_shapes):
    return [tuple(in_shapes[0]) + (int(attrs["depth"]),)]


def one_hot_torch(ctx, op, ins):
    """float32 rows, ``jax.nn.one_hot``'s: an id outside [0, depth) gives a
    row of zeros."""
    ids = ins["X"][0].to(torch.int32)
    depth = torch.arange(int(op.attrs["depth"]), dtype=torch.int32, device=ids.device)
    return {"Out": [(ids[..., None] == depth).to(torch.float32)]}


for _name in ("one_hot", "one_hot_v2"):
    OPS.register(_name, infer_shape=one_hot_shape)
    OPS.get(_name).impls["torch"] = one_hot_torch
