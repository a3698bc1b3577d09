"""Op implementations registered under the ``"cuda"`` kernel tag.

Port of ``paddle_lite_tpu/ops/kernels/ops_pallas.py``: thin wrappers that
read quant metadata from the graph and call the hand-written kernels.  One
change: the reference's impls fall back to the XLA impl when dtypes or
shapes do not fit (``ops_pallas.py:38-41``, ``:58-61``, ``:94-97``,
``:128-131``).  Here the kernel-pick pass (``ops/kernels/select.py``) has
already checked eligibility, so a mismatch raises instead of silently
running another implementation.

Per-op constants — the folded s_x·s_w scales and the GEMM weights repacked
to (N, K) — are made once per op on its first run (``ctx.const``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.registry import OPS
from ..common import normalize_2d
from ..nn import eff_scale
from . import depthwise
from .int8_matmul import int8_matmul


def _require(ok: bool, op, why: str) -> None:
    if not ok:
        raise ValueError(f"{op.op_type} (kernel='cuda'): {why}")


def _int8(op, *ts: torch.Tensor) -> None:
    _require(all(t.dtype == torch.int8 for t in ts), op,
             f"needs int8 operands, got {[t.dtype for t in ts]}")


def _packed(ctx, op, w2: torch.Tensor):
    """(K, N) weight repacked to (N, K) once; the CPU path needs none."""
    if w2.device.type == "cpu":
        return None
    return ctx.const(op, "w_nk", lambda: w2.t().contiguous())


def _gemm(ctx, op, x2, w2, x_name, w_name, bias):
    _int8(op, x2, w2)
    return int8_matmul(
        x2.contiguous(), w2, eff_scale(ctx, op, x_name, w_name), bias,
        act=op.attrs.get("fuse_act"), act_attrs=op.attrs.get("act_attrs"),
        out_scale=op.attrs.get("out_scale"), w_nk=_packed(ctx, op, w2))


@OPS.kernel("fc", "cuda")
def fc_cuda(ctx, op, ins):
    x, w = ins["Input"][0], ins["W"][0]
    bias = ins.get("Bias", [None])[0]
    ncd = int(op.attrs.get("in_num_col_dims", x.ndim - 1))
    lead = tuple(x.shape[:ncd])
    x2 = x.reshape((-1, int(np.prod(x.shape[ncd:]))))
    y = _gemm(ctx, op, x2, w, op.input("Input"), op.input("W"), bias)
    return {"Out": [y.reshape(lead + (w.shape[1],))]}


@OPS.kernel("mul", "cuda")
def mul_cuda(ctx, op, ins):
    x, w = ins["X"][0], ins["Y"][0]
    xd = int(op.attrs.get("x_num_col_dims", 1))
    yd = int(op.attrs.get("y_num_col_dims", 1))
    lead, tail = tuple(x.shape[:xd]), tuple(w.shape[yd:])
    x2 = x.reshape((-1, int(np.prod(x.shape[xd:]))))
    w2 = w.reshape((int(np.prod(w.shape[:yd])), -1))
    y = _gemm(ctx, op, x2, w2, op.input("X"), op.input("Y"), None)
    return {"Out": [y.reshape(lead + tail)]}


@OPS.kernel("conv2d", "cuda")
def conv2d_cuda(ctx, op, ins):
    """1x1 / stride-1 / group-1 conv as the int8 GEMM (the reference's
    ``conv_gemmlike`` path with im2col degenerating to a reshape)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    bias = ins.get("Bias", [None])[0]
    kh, kw, c, oc = w.shape
    _require(
        (kh, kw) == (1, 1)
        and normalize_2d(op.attrs.get("strides", (1, 1))) == (1, 1)
        and int(op.attrs.get("groups", 1)) == 1
        and "ResidualData" not in ins, op,
        "only 1x1 / stride 1 / group 1 / no residual convs run as the GEMM")
    n, h, wd, _ = x.shape
    y = _gemm(ctx, op, x.reshape((n * h * wd, c)), w.reshape((c, oc)),
              op.input("Input"), op.input("Filter"), bias)
    return {"Output": [y.reshape((n, h, wd, oc))]}


@OPS.kernel("depthwise_conv2d", "cuda")
def depthwise_cuda(ctx, op, ins):
    """int8 depthwise conv (k ∈ {3, 5}, stride ∈ {1, 2}, SAME padding)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    bias = ins.get("Bias", [None])[0]
    _int8(op, x, w)
    _require("ResidualData" not in ins
             and depthwise.supported_general(op.attrs, x.shape, w.shape), op,
             "outside the kernel's k ∈ {3,5} / stride ∈ {1,2} / SAME domain")
    y = depthwise.dw_conv_int8(
        x, w, eff_scale(ctx, op, op.input("Input"), op.input("Filter")), bias,
        stride=normalize_2d(op.attrs.get("strides", (1, 1)))[0],
        act=op.attrs.get("fuse_act"), act_attrs=op.attrs.get("act_attrs"),
        out_scale=op.attrs.get("out_scale"))
    return {"Output": [y]}
