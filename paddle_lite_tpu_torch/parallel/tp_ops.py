"""The ``"tp_cuda"`` op impls and the retag that picks them.

Port of ``paddle_lite_tpu/parallel/tp_ops.py``: int8 fc, mul and 1x1
convs run kernel 1 on the rank's output-column shard
(``tp_cuda.column_parallel_int8_matmul``); :class:`~.sharding.
ShardedPredictor` gathers the columns after the op.  Three differences
from the reference, each held by a test:

- **Nothing registers at import.**  The reference adds its impls to the
  global op table when imported (``tp_ops.py:107-109``), so importing it
  changes what an unrelated graph can run.  Here the impls live in
  :data:`TP_IMPLS`, which only a sharded run's context reads
  (``sharding.ShardedContext.impl_for``); ``core.registry.OPS`` is the
  same before and after ``import paddle_lite_tpu_torch.parallel``.
- **They raise instead of falling back.**  The reference's impls run the
  ``xla`` impl without a word when an operand is not int8, there is no
  mesh, or a conv has a residual input (``tp_ops.py:46-47``, ``:65-66``,
  ``:87-92``).  Here each raises ``ValueError`` naming the op.
- **The 1x1 gate checks paddings and dilations.**  The reference's gate
  (``tp_ops.py:84-88``, ``:128-134``) retags a padded 1x1 conv, whose
  GEMM over the unpadded pixel rows is the wrong product.  Here only an
  unpadded, dilation-1, stride-1 1x1 conv is retagged.

:func:`assign_tp_kernels` also retags only an op whose activation input is
int8 (``passes.kernel_pick.int8_activation``, the single-device kernels'
gate): an int8 op on an fp32 activation keeps its tag.
"""

from __future__ import annotations

import math

import torch

from ..ops.common import normalize_2d, normalize_paddings
from ..ops.kernels.ops_cuda import _bias, _packed
from ..ops.nn import eff_scale
from ..passes.kernel_pick import int8_activation
from .sharding import mesh_shape
from .tp_cuda import column_parallel_int8_matmul

TAG = "tp_cuda"


def _require(ok: bool, op, why: str) -> None:
    if not ok:
        raise ValueError(f"{op.op_type} (kernel={TAG!r}): {why}")


def _ready(ctx, op, x: torch.Tensor, w: torch.Tensor) -> None:
    mesh = getattr(ctx, "mesh", None)  # a ShardedContext's; a plain context has none
    _require(mesh is not None and mesh.parts("model") > 1, op,
             "needs a mesh whose 'model' axis has more than one rank "
             "(parallel.ShardedPredictor runs it)")
    _require(x.dtype == torch.int8 and w.dtype == torch.int8, op,
             f"needs int8 operands, got {x.dtype} and {w.dtype}")


def _column(ctx, op, x2, w2, x_name, w_name, bias):
    return column_parallel_int8_matmul(
        ctx.mesh, x2.contiguous(), w2, eff_scale(ctx, op, x_name, w_name), _bias(bias),
        act=op.attrs.get("fuse_act"), act_attrs=op.attrs.get("act_attrs"),
        out_scale=op.attrs.get("out_scale"), w_nk=_packed(ctx, op, w2))


def fc_tp_cuda(ctx, op, ins):
    x, w = ins["Input"][0], ins["W"][0]
    _ready(ctx, op, x, w)
    ncd = int(op.attrs.get("in_num_col_dims", x.ndim - 1))
    lead = tuple(x.shape[:ncd])
    y = _column(ctx, op, x.reshape((-1, math.prod(x.shape[ncd:]))), w, op.input("Input"),
                op.input("W"), ins.get("Bias", [None])[0])
    return {"Out": [y.reshape(lead + (w.shape[1],))]}


def mul_tp_cuda(ctx, op, ins):
    x, w = ins["X"][0], ins["Y"][0]
    _ready(ctx, op, x, w)
    xd = int(op.attrs.get("x_num_col_dims", 1))
    yd = int(op.attrs.get("y_num_col_dims", 1))
    lead, tail = tuple(x.shape[:xd]), tuple(w.shape[yd:])
    y = _column(ctx, op, x.reshape((-1, math.prod(x.shape[xd:]))),
                w.reshape((math.prod(w.shape[:yd]), -1)), op.input("X"), op.input("Y"), None)
    return {"Out": [y.reshape(lead + tail)]}


def is_plain_1x1(op, w_shape) -> bool:
    """A 1x1, stride-1, unpadded, dilation-1, group-1 conv: a GEMM over the
    input's pixel rows."""
    return (tuple(w_shape[:2]) == (1, 1)
            and normalize_2d(op.attrs.get("strides", (1, 1))) == (1, 1)
            and normalize_2d(op.attrs.get("dilations", (1, 1))) == (1, 1)
            and normalize_paddings(op.attrs.get("paddings", (0, 0))) == ((0, 0), (0, 0))
            and int(op.attrs.get("groups", 1)) == 1)


def conv1x1_tp_cuda(ctx, op, ins):
    """A 1x1 conv as a column-parallel GEMM over the (N·H·W, C) pixel rows."""
    x, w = ins["Input"][0], ins["Filter"][0]
    _ready(ctx, op, x, w)
    _require(is_plain_1x1(op, w.shape), op,
             "only a 1x1, stride-1, unpadded, dilation-1, group-1 conv runs as the GEMM")
    _require("ResidualData" not in ins, op, "a residual input is not in the GEMM's epilogue")
    n, h, wd, c = x.shape
    y = _column(ctx, op, x.reshape(n * h * wd, c), w.reshape(c, -1), op.input("Input"),
                op.input("Filter"), ins.get("Bias", [None])[0])
    return {"Output": [y.reshape(n, h, wd, w.shape[3])]}


TP_IMPLS = {"fc": fc_tp_cuda, "mul": mul_tp_cuda, "conv2d": conv1x1_tp_cuda}


def assign_tp_kernels(graph, mesh, *, tp_axis: str = "model") -> int:
    """Retag to ``"tp_cuda"`` every int8 fc / mul / plain 1x1 conv
    (:func:`is_plain_1x1`, no residual) on an int8 activation whose output
    channels the model axis divides; returns the count.  Nothing is
    retagged where the model axis has one rank.  `mesh` is a
    :class:`~.sharding.Mesh` or its shape, ``{"data": d, "model": m}``."""
    parts = mesh_shape(mesh).get(tp_axis, 1)
    n = 0
    for op in graph.ops:
        if parts == 1 or not op.attrs.get("enable_int8") or not int8_activation(graph, op):
            continue
        if op.op_type == "fc":
            ok = graph.vars[op.input("W")].shape[1] % parts == 0
        elif op.op_type == "mul":
            ok = graph.vars[op.input("Y")].shape[-1] % parts == 0
        elif op.op_type == "conv2d":
            w_shape = graph.vars[op.input("Filter")].shape
            ok = (is_plain_1x1(op, w_shape) and w_shape[3] % parts == 0
                  and not op.maybe_input("ResidualData"))
        else:
            continue
        if ok:
            op.attrs["kernel"] = TAG
            n += 1
    return n
