"""Fluid ProgramDesc → Graph converter (NCHW → NHWC).

Port of ``paddle_lite_tpu/formats/fluid_convert.py``, handler for handler:
fluid graphs are NCHW, this engine is NHWC, and the layout is converted at
import time (the reference's ``type_layout_cast_pass`` role):

- conv/pool/interp/detection ops run natively NHWC; their fluid-name output
  vars physically hold NHWC data (tracked in ``phys_layout``);
- axis-bearing ops on NHWC tensors get their axes remapped
  (NCHW axis → NHWC axis) when the op is rank-preserving;
- ops whose fluid semantics depend on NCHW memory order (reshape/flatten
  over real spatial extent, rank-reducing reductions) get an explicit
  ``transpose`` back to NCHW (:meth:`FluidConverter.ensure_sem`), the only
  places a real data movement is paid;
- a fluid ``transpose2`` on an NHWC tensor is *re-based* onto the physical
  layout (the common SSD-head NCHW→NHWC transpose becomes an ``assign``).

Weights: conv filters OIHW→HWIO; fc/mul weights are (K, N) in fluid already.
QAT graphs (PaddleSlim ``fake_quantize_*``/``fake_dequantize_*`` ops) are
imported as-is — ``quant_dequant_fuse`` consumes them during optimize().
An op type outside the port's registry raises :class:`FluidFormatError`
(:meth:`FluidConverter._generic`), as in the reference.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.ir import Graph
from ..core.registry import OPS
from ..core.types import Precision
from .fluid import (
    VT_FEED_MINIBATCH,
    VT_FETCH_LIST,
    _VT_TO_NP,
    _VT_TO_PRECISION,
    FluidFormatError,
    FluidOp,
    FluidProgram,
)

# semantic NCHW axis -> physical NHWC axis
_SEM_TO_PHYS = {0: 0, 1: 3, 2: 1, 3: 2}

_UNARY_ACTS = {
    "relu", "relu6", "sigmoid", "hard_sigmoid", "hard_swish", "swish",
    "tanh", "leaky_relu", "gelu", "exp", "sqrt", "rsqrt", "abs", "mish",
    "elu", "softplus", "softsign", "erf", "floor", "ceil", "round", "log",
    "square", "silu", "sign", "reciprocal", "cos", "sin", "clip", "prelu",
    "relu_clipped",
}

# pure-passthrough unary plumbing (layout preserved, attrs copied)
_UNARY_PLUMBING = {"scale", "dropout", "cast", "assign"}

_FAKE_QUANT_OPS = {
    "fake_quantize_abs_max",
    "fake_quantize_range_abs_max",
    "fake_quantize_moving_average_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_quantize_dequantize_abs_max",
    "fake_dequantize_max_abs",
    "fake_channel_wise_dequantize_max_abs",
}

_REDUCES = {"reduce_mean", "reduce_sum", "reduce_max", "reduce_min",
            "reduce_prod", "reduce_all", "reduce_any"}


class FluidConverter:
    def __init__(self, prog: FluidProgram, params: Dict[str, np.ndarray],
                 *, batch: int = 1, name: str = "fluid_model"):
        if len(prog.blocks) > 1:
            used = {a for op in prog.main.ops
                    for a in op.attrs.values() if op.type in ("while", "conditional_block")}
            if used:
                raise FluidFormatError(
                    "multi-block control flow (while/conditional_block) "
                    "import is not supported yet")
        self.prog = prog
        self.params = params
        self.batch = batch
        self.g = Graph(name)
        self.alias: Dict[str, str] = {}          # fluid name -> graph var
        self.phys_layout: Dict[str, Optional[str]] = {}  # graph var -> "nhwc"|None
        self._nhwc_cache: Dict[str, str] = {}
        self._sem_cache: Dict[str, str] = {}
        self._loaded_weights: Dict[str, str] = {}  # fluid name -> transform tag

    # ---- var plumbing ------------------------------------------------------

    def resolve(self, fluid_name: str) -> str:
        return self.alias.get(fluid_name, fluid_name)

    def fluid_shape(self, name: str) -> Tuple[int, ...]:
        var = self.prog.main.vars.get(name)
        if var is None:
            raise FluidFormatError(f"op references undeclared var {name!r}")
        return tuple(self.batch if d == -1 else int(d) for d in var.shape)

    def _precision_of(self, fluid_name: str, default=Precision.FP32) -> Precision:
        var = self.prog.main.vars.get(fluid_name)
        if var is None:
            return default
        return _VT_TO_PRECISION.get(var.dtype, default)

    def add_weight(self, fluid_name: str, transform: str = "none") -> str:
        """Materialize a persistable var as a graph weight; `transform`
        distinguishes layout variants ('conv_filter' → OIHW→HWIO)."""
        prev = self._loaded_weights.get(fluid_name)
        if prev == transform:
            return fluid_name if transform == "none" else f"{fluid_name}.{transform}"
        val = self.params.get(fluid_name)
        if val is None:
            raise FluidFormatError(f"missing param tensor {fluid_name!r}")
        if transform == "conv_filter":
            val = np.transpose(val, (2, 3, 1, 0))  # OIHW -> HWIO
            name = f"{fluid_name}.{transform}"
        else:
            name = fluid_name
        if name not in self.g.vars:
            self.g.add_weight(name, np.ascontiguousarray(val))
        self._loaded_weights[fluid_name] = transform
        return name

    def _maybe_weight(self, fluid_name: str, transform: str = "none") -> str:
        """Resolve an input: graph var if produced, else persistable param."""
        resolved = self.resolve(fluid_name)
        if resolved in self.g.vars:
            return resolved
        if fluid_name in self.params:
            return self.add_weight(fluid_name, transform)
        raise FluidFormatError(f"input var {fluid_name!r} neither produced "
                               f"nor persistable")

    def _new_out(self, fluid_name: str, shape: Sequence[int],
                 layout: Optional[str], precision=None) -> str:
        prec = precision or self._precision_of(fluid_name)
        self.g.add_var(fluid_name, shape, precision=prec)
        self.phys_layout[fluid_name] = layout
        return fluid_name

    def _emit(self, op_type: str, inputs: Dict[str, List[str]],
              fluid_outs: Dict[str, List[str]], attrs: Dict[str, Any],
              *, shape_args: Optional[List[str]] = None,
              out_layout: Optional[str] = None,
              out_precisions: Optional[List[Precision]] = None) -> None:
        """Create output vars via our registered infer_shape and add the op."""
        opdef = OPS.get(op_type)
        if opdef.infer_shape is None:
            raise FluidFormatError(f"op {op_type!r} has no infer_shape")
        shape_args = shape_args if shape_args is not None else [
            n for ns in inputs.values() for n in ns]
        in_shapes = [self.g.vars[n].shape for n in shape_args]
        out_shapes = opdef.infer_shape(attrs, in_shapes)
        flat_outs = [n for ns in fluid_outs.values() for n in ns]
        if len(flat_outs) != len(out_shapes):
            raise FluidFormatError(
                f"{op_type}: fluid has {len(flat_outs)} outputs, "
                f"infer_shape produced {len(out_shapes)}")
        i = 0
        for ns in fluid_outs.values():
            for n in ns:
                prec = out_precisions[i] if out_precisions else None
                self._new_out(n, out_shapes[i], out_layout, precision=prec)
                i += 1
        self.g.add_op(op_type, inputs, fluid_outs, attrs)

    # ---- layout helpers ------------------------------------------------------

    def ensure_nhwc(self, var: str) -> str:
        """Physical NHWC view of a graph var (4-D only)."""
        if self.phys_layout.get(var) == "nhwc":
            return var
        shape = self.g.vars[var].shape
        if len(shape) != 4:
            return var
        if var in self._nhwc_cache:
            return self._nhwc_cache[var]
        out = self.g.unique_name(var + ".nhwc")
        n, c, h, wd = shape
        self.g.add_var(out, (n, h, wd, c))
        self.g.add_op("transpose", {"X": [var]}, {"Out": [out]},
                      {"axis": [0, 2, 3, 1]})
        self.phys_layout[out] = "nhwc"
        self._nhwc_cache[var] = out
        return out

    def ensure_sem(self, var: str) -> str:
        """Fluid-semantic (NCHW-ordered) view of a graph var."""
        if self.phys_layout.get(var) != "nhwc":
            return var
        if var in self._sem_cache:
            return self._sem_cache[var]
        out = self.g.unique_name(var + ".nchw")
        n, h, wd, c = self.g.vars[var].shape
        self.g.add_var(out, (n, c, h, wd))
        self.g.add_op("transpose", {"X": [var]}, {"Out": [out]},
                      {"axis": [0, 3, 1, 2]})
        self.phys_layout[out] = None
        self._sem_cache[var] = out
        return out

    def _remap_axis(self, var: str, axis: int) -> int:
        """Fluid axis on `var` → physical axis (identity unless NHWC 4-D)."""
        rank = len(self.g.vars[var].shape)
        axis = axis % rank if rank else axis
        if self.phys_layout.get(var) == "nhwc" and rank == 4:
            return _SEM_TO_PHYS[axis]
        return axis

    # ---- op handlers ---------------------------------------------------------

    def convert(self) -> Graph:
        for op in self.prog.main.ops:
            handler = getattr(self, f"_op_{op.type}", None)
            if handler is not None:
                handler(op)
            elif op.type in _UNARY_ACTS or op.type in _UNARY_PLUMBING:
                self._unary(op)
            elif op.type in _FAKE_QUANT_OPS:
                self._fake_quant(op)
            elif op.type in _REDUCES:
                self._reduce(op)
            else:
                self._generic(op)
        self.g.rebuild_links()
        self.g.remove_unused_vars()
        return self.g

    # feed/fetch --------------------------------------------------------------

    def _op_feed(self, op: FluidOp) -> None:
        out = op.output("Out")
        shape = self.fluid_shape(out)
        self._new_out(out, shape, None)
        self.g.inputs.append(out)

    def _op_fetch(self, op: FluidOp) -> None:
        x = self.ensure_sem(self._maybe_weight(op.input("X")))
        self.g.outputs.append(x)

    # convolution family --------------------------------------------------------

    def _conv(self, op: FluidOp, op_type: str) -> None:
        x = self.ensure_nhwc(self._maybe_weight(op.input("Input")))
        f = self._maybe_weight(op.input("Filter"), transform="conv_filter")
        ins = {"Input": [x], "Filter": [f]}
        if op.maybe_input("Bias"):
            ins["Bias"] = [self._maybe_weight(op.input("Bias"))]
        if op.maybe_input("ResidualData"):
            ins["ResidualData"] = [
                self.ensure_nhwc(self._maybe_weight(op.input("ResidualData")))]
        paddings = [int(p) for p in op.attrs.get("paddings", [0, 0])]
        attrs = {
            "strides": [int(s) for s in op.attrs.get("strides", [1, 1])],
            "paddings": paddings,
            "dilations": [int(d) for d in op.attrs.get("dilations", [1, 1])],
            "groups": int(op.attrs.get("groups", 1)),
        }
        if op.attrs.get("padding_algorithm") in ("SAME", "VALID"):
            attrs["padding_algorithm"] = op.attrs["padding_algorithm"]
        if op.attrs.get("fuse_relu"):
            attrs["fuse_act"] = "relu"
        self._emit(op_type, ins, {"Output": [op.output("Output")]}, attrs,
                   shape_args=[x, f], out_layout="nhwc")

    def _op_conv2d(self, op: FluidOp) -> None:
        # fluid marks group==C convs as depthwise_conv2d; a conv2d with
        # groups == in_channels is mapped to the depthwise path too
        self._conv(op, "conv2d")

    def _op_depthwise_conv2d(self, op: FluidOp) -> None:
        self._conv(op, "depthwise_conv2d")

    def _op_batch_norm(self, op: FluidOp) -> None:
        x = self._maybe_weight(op.input("X"))
        ins = {"X": [x]}
        for slot in ("Scale", "Bias", "Mean", "Variance"):
            ins[slot] = [self._maybe_weight(op.input(slot))]
        attrs = {"epsilon": float(op.attrs.get("epsilon", 1e-5))}
        self._emit("batch_norm", ins, {"Y": [op.output("Y")]}, attrs,
                   shape_args=[x], out_layout=self.phys_layout.get(x))

    def _op_pool2d(self, op: FluidOp) -> None:
        x = self.ensure_nhwc(self._maybe_weight(op.input("X")))
        attrs = {
            "pooling_type": op.attrs.get("pooling_type", "max"),
            "ksize": [int(k) for k in op.attrs.get("ksize", [1, 1])],
            "strides": [int(s) for s in op.attrs.get("strides", [1, 1])],
            "paddings": [int(p) for p in op.attrs.get("paddings", [0, 0])],
            "global_pooling": bool(op.attrs.get("global_pooling", False)),
            "ceil_mode": bool(op.attrs.get("ceil_mode", False)),
            "exclusive": bool(op.attrs.get("exclusive", True)),
        }
        if op.attrs.get("adaptive"):
            # adaptive pooling to 1x1 == global; other sizes unsupported
            if list(op.attrs.get("ksize", [])) in ([1, 1], [1]):
                attrs["global_pooling"] = True
            else:
                raise FluidFormatError("adaptive pool2d to >1x1 unsupported")
        self._emit("pool2d", {"X": [x]}, {"Out": [op.output("Out")]}, attrs,
                   shape_args=[x], out_layout="nhwc")

    # linear family ---------------------------------------------------------------

    def _op_mul(self, op: FluidOp) -> None:
        x = self.ensure_sem(self._maybe_weight(op.input("X")))
        y = self._maybe_weight(op.input("Y"))
        attrs = {
            "x_num_col_dims": int(op.attrs.get("x_num_col_dims", 1)),
            "y_num_col_dims": int(op.attrs.get("y_num_col_dims", 1)),
        }
        self._emit("mul", {"X": [x], "Y": [y]}, {"Out": [op.output("Out")]},
                   attrs, shape_args=[x, y])

    def _op_fc(self, op: FluidOp) -> None:
        x = self.ensure_sem(self._maybe_weight(op.input("Input")))
        wt = self._maybe_weight(op.input("W"))
        ins = {"Input": [x], "W": [wt]}
        if op.maybe_input("Bias"):
            ins["Bias"] = [self._maybe_weight(op.input("Bias"))]
        attrs = {"in_num_col_dims": int(op.attrs.get("in_num_col_dims", 1))}
        if op.attrs.get("activation_type"):
            attrs["fuse_act"] = op.attrs["activation_type"]
        self._emit("fc", ins, {"Out": [op.output("Out")]}, attrs,
                   shape_args=[x, wt])

    def _op_matmul(self, op: FluidOp) -> None:
        x = self.ensure_sem(self._maybe_weight(op.input("X")))
        y = self.ensure_sem(self._maybe_weight(op.input("Y")))
        attrs = {
            "transpose_X": bool(op.attrs.get("transpose_X",
                                             op.attrs.get("trans_x", False))),
            "transpose_Y": bool(op.attrs.get("transpose_Y",
                                             op.attrs.get("trans_y", False))),
            "alpha": float(op.attrs.get("alpha", 1.0)),
        }
        self._emit("matmul", {"X": [x], "Y": [y]}, {"Out": [op.output("Out")]},
                   attrs, shape_args=[x, y])

    _op_matmul_v2 = _op_matmul

    # unary / plumbing -------------------------------------------------------------

    def _unary(self, op: FluidOp) -> None:
        x = self._maybe_weight(op.input("X"))
        fluid_outs = {"Out": [op.output("Out")]}
        attrs = {k: v for k, v in op.attrs.items()
                 if not k.startswith(("op_", "use_", "is_test", "mkldnn"))}
        if op.type == "dropout":
            # inference: upscale_in_train == identity; downgrade scales
            attrs = {"dropout_prob": float(op.attrs.get("dropout_prob", 0.5)),
                     "dropout_implementation":
                         op.attrs.get("dropout_implementation",
                                      "downgrade_in_infer")}
        self._emit(op.type, {"X": [x]}, fluid_outs, attrs, shape_args=[x],
                   out_layout=self.phys_layout.get(x))

    def _fake_quant(self, op: FluidOp) -> None:
        x = self._maybe_weight(op.input("X"))
        ins = {"X": [x]}
        for slot in ("InScale", "Scales"):
            if op.maybe_input(slot):
                ins[slot] = [self._maybe_weight(n) for n in op.inputs[slot]]
        outs = {"Out": [op.output("Out")]}
        attrs = dict(op.attrs)
        self._emit(op.type, ins, outs, attrs, shape_args=[x],
                   out_layout=self.phys_layout.get(x))
        # propagate an OutScale weight if the desc declares one (training
        # artifact; harmless to drop)

    # elementwise -------------------------------------------------------------------

    def _eltwise(self, op: FluidOp) -> None:
        x = self._maybe_weight(op.input("X"))
        y = self._maybe_weight(op.input("Y"))
        xs, ys = self.g.vars[x].shape, self.g.vars[y].shape
        axis = int(op.attrs.get("axis", -1))
        lx = self.phys_layout.get(x)
        ly = self.phys_layout.get(y)
        if len(xs) == 4 and len(ys) == 4:
            if lx == "nhwc" or ly == "nhwc":
                x, y = self.ensure_nhwc(x), self.ensure_nhwc(y)
                out_layout = "nhwc"
            else:
                out_layout = None
            axis = -1
        elif lx == "nhwc":
            if len(ys) == 1 and axis in (1, -3):
                axis = -1          # channel bias: trailing axis in NHWC
                out_layout = "nhwc"
            elif len(ys) == 3 and axis in (1, -3):
                # y spans C,H,W: needs NCHW ordering
                x = self.ensure_sem(x)
                out_layout = None
            elif axis in (-1, len(xs) - 1):
                # fluid trailing axis == W; NHWC trailing is C
                x = self.ensure_sem(x)
                out_layout = None
            else:
                x = self.ensure_sem(x)
                out_layout = None
        else:
            y = self.ensure_sem(y)
            out_layout = None
        self._emit(op.type, {"X": [x], "Y": [y]}, {"Out": [op.output("Out")]},
                   {"axis": axis}, shape_args=[x, y], out_layout=out_layout)

    _op_elementwise_add = _eltwise
    _op_elementwise_sub = _eltwise
    _op_elementwise_mul = _eltwise
    _op_elementwise_div = _eltwise
    _op_elementwise_max = _eltwise
    _op_elementwise_min = _eltwise
    _op_elementwise_pow = _eltwise

    # axis-bearing rank-preserving ops ------------------------------------------------

    def _op_softmax(self, op: FluidOp) -> None:
        x = self._maybe_weight(op.input("X"))
        axis = self._remap_axis(x, int(op.attrs.get("axis", -1)))
        self._emit("softmax", {"X": [x]}, {"Out": [op.output("Out")]},
                   {"axis": axis}, shape_args=[x],
                   out_layout=self.phys_layout.get(x))

    def _op_concat(self, op: FluidOp) -> None:
        xs = [self._maybe_weight(n) for n in op.inputs["X"]]
        layouts = {self.phys_layout.get(n) for n in xs}
        if "nhwc" in layouts and len(layouts) > 1:
            xs = [self.ensure_nhwc(n) for n in xs]
        axis = self._remap_axis(xs[0], int(op.attrs.get("axis", 0)))
        self._emit("concat", {"X": xs}, {"Out": [op.output("Out")]},
                   {"axis": axis}, shape_args=xs,
                   out_layout=self.phys_layout.get(xs[0]))

    def _op_split(self, op: FluidOp) -> None:
        x = self._maybe_weight(op.input("X"))
        axis = self._remap_axis(x, int(op.attrs.get("axis", 0)))
        attrs = {"axis": axis,
                 "num": int(op.attrs.get("num", 0)),
                 "sections": [int(s) for s in op.attrs.get("sections", [])]}
        self._emit("split", {"X": [x]}, {"Out": list(op.outputs["Out"])},
                   attrs, shape_args=[x],
                   out_layout=self.phys_layout.get(x))

    def _reduce(self, op: FluidOp) -> None:
        x = self._maybe_weight(op.input("X"))
        keep = bool(op.attrs.get("keep_dim", False))
        if self.phys_layout.get(x) == "nhwc" and not keep:
            x = self.ensure_sem(x)  # rank-reducing: axis order must be NCHW
        dims = [self._remap_axis(x, int(d)) for d in op.attrs.get("dim", [0])]
        attrs = {"dim": dims, "keep_dim": keep,
                 "reduce_all": bool(op.attrs.get("reduce_all", False))}
        self._emit(op.type, {"X": [x]}, {"Out": [op.output("Out")]}, attrs,
                   shape_args=[x], out_layout=self.phys_layout.get(x))

    def _op_arg_max(self, op: FluidOp) -> None:
        x = self.ensure_sem(self._maybe_weight(op.input("X")))
        attrs = {"axis": int(op.attrs.get("axis", -1)),
                 "keepdims": bool(op.attrs.get("keepdims", False))}
        self._emit("arg_max", {"X": [x]}, {"Out": [op.output("Out")]}, attrs,
                   shape_args=[x], out_precisions=[Precision.INT64])

    # layout-sensitive shape ops --------------------------------------------------------

    def _op_transpose(self, op: FluidOp) -> None:
        x = self._maybe_weight(op.input("X"))
        perm = [int(a) for a in op.attrs["axis"]]
        if self.phys_layout.get(x) == "nhwc" and len(perm) == 4:
            perm = [_SEM_TO_PHYS[a] for a in perm]
            if perm == [0, 1, 2, 3]:
                # fluid NCHW→NHWC transpose of a tensor we already hold in
                # NHWC: physically a no-op (the common SSD-head case).
                # Emit `assign` (an alias, no copy) so the output var gets
                # its own layout entry (None: it is its own semantic self).
                self._emit("assign", {"X": [x]},
                           {"Out": [op.output("Out")]}, {}, shape_args=[x])
                return
        self._emit("transpose", {"X": [x]}, {"Out": [op.output("Out")]},
                   {"axis": perm}, shape_args=[x])

    _op_transpose2 = _op_transpose

    def _op_reshape(self, op: FluidOp) -> None:
        x = self._maybe_weight(op.input("X"))
        shape_attr = [int(s) for s in op.attrs.get("shape", [])]
        xs = self.g.vars[x].shape
        if self.phys_layout.get(x) == "nhwc":
            n, h, wd, c = xs
            if h * wd != 1:
                x = self.ensure_sem(x)  # memory order matters
            # else: (N,1,1,C) flattens identically in either order
        self._emit("reshape", {"X": [x]}, {"Out": [op.output("Out")]},
                   {"shape": shape_attr}, shape_args=[x])

    _op_reshape2 = _op_reshape

    def _op_flatten(self, op: FluidOp) -> None:
        x = self._maybe_weight(op.input("X"))
        xs = self.g.vars[x].shape
        if self.phys_layout.get(x) == "nhwc" and xs[1] * xs[2] != 1:
            x = self.ensure_sem(x)
        attrs = {"axis": int(op.attrs.get("axis", 1))}
        if "start_axis" in op.attrs:  # flatten_contiguous_range
            attrs = {"start_axis": int(op.attrs["start_axis"]),
                     "stop_axis": int(op.attrs.get("stop_axis", -1))}
        self._emit(op.type if op.type in ("flatten", "flatten2",
                                          "flatten_contiguous_range")
                   else "flatten",
                   {"X": [x]}, {"Out": [op.output("Out")]}, attrs,
                   shape_args=[x])

    _op_flatten2 = _op_flatten
    _op_flatten_contiguous_range = _op_flatten

    def _op_squeeze(self, op: FluidOp) -> None:
        x = self.ensure_sem(self._maybe_weight(op.input("X")))
        attrs = {"axes": [int(a) for a in op.attrs.get("axes", [])]}
        self._emit(op.type, {"X": [x]}, {"Out": [op.output("Out")]}, attrs,
                   shape_args=[x])

    _op_squeeze2 = _op_squeeze

    def _op_unsqueeze(self, op: FluidOp) -> None:
        x = self.ensure_sem(self._maybe_weight(op.input("X")))
        attrs = {"axes": [int(a) for a in op.attrs.get("axes", [])]}
        self._emit(op.type, {"X": [x]}, {"Out": [op.output("Out")]}, attrs,
                   shape_args=[x])

    _op_unsqueeze2 = _op_unsqueeze

    def _op_slice(self, op: FluidOp) -> None:
        x = self.ensure_sem(self._maybe_weight(op.input("X")))
        attrs = {"axes": [int(a) for a in op.attrs.get("axes", [])],
                 "starts": [int(s) for s in op.attrs.get("starts", [])],
                 "ends": [int(e) for e in op.attrs.get("ends", [])]}
        self._emit("slice", {"X": [x]}, {"Out": [op.output("Out")]}, attrs,
                   shape_args=[x])

    def _op_gru(self, op: FluidOp) -> None:
        """Fluid ``gru`` (LoD recurrence — ``lite/operators/gru_op.cc``)
        imported in the DENSE-BATCH form (SURVEY §5.7: LoD raggedness is a
        non-goal; sequences arrive dense (N, T, 3H) from the bucketed
        batcher).  Maps onto the engine's ``gru`` op (same slot contract,
        ``is_reverse`` supported); the training-side outputs the fluid desc
        declares (BatchGate/BatchResetHiddenPrev/BatchHidden) are not
        materialized — inference exports never consume them."""
        x = self.ensure_sem(self._maybe_weight(op.input("Input")))
        if len(self.g.vars[x].shape) != 3:
            raise FluidFormatError(
                "gru import expects a dense (batch, T, 3H) Input; ragged "
                "LoD sequences must be bucketed before export (§5.7)")
        if bool(op.attrs.get("origin_mode", False)):
            # origin_mode flips the update-gate formula
            # (h = (1-u)*h_prev + u*c); the engine gru kernel implements
            # only the default form — importing silently would produce
            # wrong outputs, so refuse loudly.
            raise FluidFormatError(
                "gru origin_mode=True is not supported (the engine gru "
                "kernel implements the default update-gate formula)")
        ins = {"Input": [x], "Weight": [self._maybe_weight(op.input("Weight"))]}
        if op.maybe_input("Bias"):
            ins["Bias"] = [self._maybe_weight(op.input("Bias"))]
        if op.maybe_input("H0"):
            ins["H0"] = [self._maybe_weight(op.input("H0"))]
        attrs = {
            "is_reverse": bool(op.attrs.get("is_reverse", False)),
            "gate_activation": op.attrs.get("gate_activation", "sigmoid"),
            "activation": op.attrs.get("activation", "tanh"),
        }
        self._emit("gru", ins, {"Hidden": [op.output("Hidden")]}, attrs,
                   shape_args=[x])

    def _op_shape(self, op: FluidOp) -> None:
        x = self.ensure_sem(self._maybe_weight(op.input("Input")))
        self._emit("shape", {"Input": [x]}, {"Out": [op.output("Out")]}, {},
                   shape_args=[x], out_precisions=[Precision.INT32])

    def _op_stack(self, op: FluidOp) -> None:
        xs = [self.ensure_sem(self._maybe_weight(n)) for n in op.inputs["X"]]
        self._emit("stack", {"X": xs}, {"Y": [op.output("Y")]},
                   {"axis": int(op.attrs.get("axis", 0))}, shape_args=xs)

    # interpolation -----------------------------------------------------------------

    def _interp(self, op: FluidOp) -> None:
        x = self.ensure_nhwc(self._maybe_weight(op.input("X")))
        attrs = {
            "out_h": int(op.attrs.get("out_h", -1)),
            "out_w": int(op.attrs.get("out_w", -1)),
            "scale": op.attrs.get("scale", 0.0),
            "align_corners": bool(op.attrs.get("align_corners", True)),
            "align_mode": int(op.attrs.get("align_mode", 1)),
        }
        self._emit(op.type, {"X": [x]}, {"Out": [op.output("Out")]}, attrs,
                   shape_args=[x], out_layout="nhwc")

    _op_nearest_interp = _interp
    _op_bilinear_interp = _interp
    _op_nearest_interp_v2 = _interp
    _op_bilinear_interp_v2 = _interp

    # normalization / embedding -------------------------------------------------------

    def _op_layer_norm(self, op: FluidOp) -> None:
        x = self.ensure_sem(self._maybe_weight(op.input("X")))
        ins = {"X": [x]}
        for slot in ("Scale", "Bias"):
            if op.maybe_input(slot):
                ins[slot] = [self._maybe_weight(op.input(slot))]
        attrs = {"epsilon": float(op.attrs.get("epsilon", 1e-5)),
                 "begin_norm_axis": int(op.attrs.get("begin_norm_axis", 1))}
        self._emit("layer_norm", ins, {"Y": [op.output("Y")]}, attrs,
                   shape_args=[x])

    def _op_lookup_table(self, op: FluidOp) -> None:
        ids = self._maybe_weight(op.input("Ids"))
        wt = self._maybe_weight(op.input("W"))
        self._emit(op.type, {"Ids": [ids], "W": [wt]},
                   {"Out": [op.output("Out")]},
                   {"padding_idx": int(op.attrs.get("padding_idx", -1))},
                   shape_args=[ids, wt])

    _op_lookup_table_v2 = _op_lookup_table

    # detection ---------------------------------------------------------------------

    def _op_prior_box(self, op: FluidOp) -> None:
        feat = self.ensure_nhwc(self._maybe_weight(op.input("Input")))
        img = self.ensure_nhwc(self._maybe_weight(op.input("Image")))
        attrs = {k: v for k, v in op.attrs.items()}
        self._emit("prior_box", {"Input": [feat], "Image": [img]},
                   {"Boxes": [op.output("Boxes")],
                    "Variances": [op.output("Variances")]},
                   attrs, shape_args=[feat, img])

    def _op_density_prior_box(self, op: FluidOp) -> None:
        feat = self.ensure_nhwc(self._maybe_weight(op.input("Input")))
        img = self.ensure_nhwc(self._maybe_weight(op.input("Image")))
        self._emit("density_prior_box", {"Input": [feat], "Image": [img]},
                   {"Boxes": [op.output("Boxes")],
                    "Variances": [op.output("Variances")]},
                   dict(op.attrs), shape_args=[feat, img])

    def _op_box_coder(self, op: FluidOp) -> None:
        ins = {"PriorBox": [self._maybe_weight(op.input("PriorBox"))],
               "TargetBox": [self.ensure_sem(self._maybe_weight(op.input("TargetBox")))]}
        shape_args = [ins["PriorBox"][0]]
        if op.maybe_input("PriorBoxVar"):
            ins["PriorBoxVar"] = [self._maybe_weight(op.input("PriorBoxVar"))]
            shape_args.append(ins["PriorBoxVar"][0])
        # TargetBox last — box_coder_shape reads in_shapes[-1]
        shape_args.append(ins["TargetBox"][0])
        self._emit("box_coder", ins, {"OutputBox": [op.output("OutputBox")]},
                   dict(op.attrs), shape_args=shape_args)

    def _op_multiclass_nms(self, op: FluidOp) -> None:
        bb = self.ensure_sem(self._maybe_weight(op.input("BBoxes")))
        sc = self.ensure_sem(self._maybe_weight(op.input("Scores")))
        # fluid multiclass_nms takes Scores as (N, C, M) — classes before
        # priors (lite/operators/multiclass_nms_op.cc slot contract); our
        # kernel batches per-class NMS from (N, M, C).  Insert the
        # counter-transpose when the fluid layout is detected (C==M graphs
        # are ambiguous and pass through — both readings agree there).
        m = self.g.vars[bb].shape[1]
        s_shape = self.g.vars[sc].shape
        if len(s_shape) == 3 and s_shape[1] != m and s_shape[2] == m:
            out = self.g.unique_name(sc + ".nmc")
            n, c_, _ = s_shape
            self.g.add_var(out, (n, m, c_))
            self.g.add_op("transpose", {"X": [sc]}, {"Out": [out]},
                          {"axis": [0, 2, 1]})
            sc = out
        ins = {"BBoxes": [bb], "Scores": [sc]}
        self._emit(op.type, ins, {"Out": [op.output("Out")]}, dict(op.attrs),
                   shape_args=[ins["BBoxes"][0], ins["Scores"][0]])

    _op_multiclass_nms2 = _op_multiclass_nms

    def _op_yolo_box(self, op: FluidOp) -> None:
        x = self.ensure_nhwc(self._maybe_weight(op.input("X")))
        img = self._maybe_weight(op.input("ImgSize"))
        self._emit("yolo_box", {"X": [x], "ImgSize": [img]},
                   {"Boxes": [op.output("Boxes")],
                    "Scores": [op.output("Scores")]},
                   dict(op.attrs), shape_args=[x, img])

    # misc ---------------------------------------------------------------------------

    def _op_fill_constant(self, op: FluidOp) -> None:
        attrs = {"shape": [int(s) for s in op.attrs.get("shape", [])],
                 "value": float(op.attrs.get("value", 0.0)),
                 "dtype": int(op.attrs.get("dtype", VT_FP32))}
        np_dtype = _VT_TO_NP.get(attrs["dtype"], np.float32)
        prec = _VT_TO_PRECISION.get(attrs["dtype"], Precision.FP32)
        self._emit("fill_constant", {}, {"Out": [op.output("Out")]},
                   {"shape": attrs["shape"], "value": attrs["value"],
                    "dtype": np.dtype(np_dtype).name},
                   shape_args=[], out_precisions=[prec])

    def _generic(self, op: FluidOp) -> None:
        """Fallback: op types whose slots/attrs already match our registry
        and that are layout-insensitive. Inputs are materialized in fluid
        semantic order for safety."""
        if op.type not in OPS:
            raise FluidFormatError(
                f"unsupported fluid op {op.type!r} "
                f"(inputs {list(op.inputs)}, outputs {list(op.outputs)})")
        ins = {slot: [self.ensure_sem(self._maybe_weight(n)) for n in ns]
               for slot, ns in op.inputs.items() if ns}
        outs = {slot: list(ns) for slot, ns in op.outputs.items() if ns}
        self._emit(op.type, ins, outs, dict(op.attrs))


def fluid_to_graph(prog: FluidProgram, params: Dict[str, np.ndarray],
                   *, batch: int = 1, name: str = "fluid_model") -> Graph:
    """Convert a parsed fluid program + params to an executable Graph.

    Inputs/outputs keep fluid NCHW shapes and names (clients feed NCHW);
    internally the graph runs NHWC with layout casts only where required.
    """
    return FluidConverter(prog, params, batch=batch, name=name).convert()


def load_fluid_model(path: str, *, batch: int = 1) -> Graph:
    """``LoadModelPb`` analog: fluid model directory → optimizable Graph."""
    from .fluid import load_fluid_dir

    prog, params = load_fluid_dir(path)
    return fluid_to_graph(prog, params, batch=batch,
                          name=os.path.basename(os.path.normpath(path)))
