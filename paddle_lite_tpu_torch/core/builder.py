"""GraphBuilder — programmatic model construction API.

Copy of ``paddle_lite_tpu/core/builder.py`` (numpy only).  Weights are drawn
from ``np.random.default_rng(seed)`` in the same order as there, so one seed
gives bit-identical weights, ops, attrs and var shapes in both packages.
The builder eagerly runs each op's registered ``infer_shape`` (the
``OpLite::CheckShape/InferShape`` analog) so every variable has a static
shape, and models are emitted *unfused* (conv → batch_norm → relu as
separate nodes) so the optimization pipeline performs the fusions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .ir import Graph
from .registry import OPS
from .types import Precision


class GraphBuilder:
    def __init__(self, name: str = "model", seed: int = 0):
        self.g = Graph(name)
        self.rng = np.random.default_rng(seed)
        self._n = 0

    # ---- naming ----------------------------------------------------------
    def _name(self, base: str) -> str:
        self._n += 1
        return f"{base}_{self._n}"

    # ---- vars ------------------------------------------------------------
    def input(self, name: str, shape: Sequence[int],
              precision: Precision = Precision.FP32) -> str:
        self.g.add_var(name, shape, precision=precision)
        self.g.inputs.append(name)
        return name

    def weight(self, name: str, value: np.ndarray) -> str:
        self.g.add_weight(name, np.asarray(value))
        return name

    def rand_weight(self, name: str, shape: Sequence[int], scale: float = None) -> str:
        # he-style init keeps activation magnitudes sane for calibration tests
        fan_in = int(np.prod(shape[:-1])) or 1
        s = scale if scale is not None else np.sqrt(2.0 / fan_in)
        return self.weight(name, self.rng.normal(0.0, s, size=shape).astype(np.float32))

    def mark_output(self, *names: str) -> None:
        self.g.outputs.extend(names)

    # ---- generic op ------------------------------------------------------
    def op(
        self,
        op_type: str,
        inputs: Dict[str, List[str]],
        attrs: Optional[Dict[str, Any]] = None,
        shape_args: Optional[List[str]] = None,
        out_slots: Sequence[str] = ("Out",),
        out_precisions: Optional[Sequence[Precision]] = None,
        out_name: Optional[str] = None,
    ) -> List[str]:
        """Add an op; returns its output var names (one per out slot entry,
        except ops whose shape fn returns several shapes for one slot, e.g.
        split, which get them all under the first slot)."""
        attrs = dict(attrs or {})
        opdef = OPS.get(op_type)
        if opdef.infer_shape is None:
            raise ValueError(f"op {op_type!r} has no infer_shape")
        shape_args = shape_args if shape_args is not None else [
            n for ns in inputs.values() for n in ns
        ]
        in_shapes = [self.g.vars[n].shape for n in shape_args]
        out_shapes = opdef.infer_shape(attrs, in_shapes)
        out_names: List[str] = []
        outputs: Dict[str, List[str]] = {s: [] for s in out_slots}
        if len(out_slots) == len(out_shapes):
            slot_for = list(out_slots)
        else:  # multi-output single slot (split)
            slot_for = [out_slots[0]] * len(out_shapes)
        for i, shp in enumerate(out_shapes):
            prec = (out_precisions[i] if out_precisions else Precision.FP32)
            name = self._name(out_name or op_type)
            self.g.add_var(name, shp, precision=prec)
            outputs[slot_for[i]].append(name)
            out_names.append(name)
        self.g.add_op(op_type, inputs, outputs, attrs)
        return out_names

    # ---- common layer helpers --------------------------------------------
    def conv2d(
        self,
        x: str,
        out_channels: int,
        kernel: int | Sequence[int],
        stride: int | Sequence[int] = 1,
        padding: int | Sequence[int] = 0,
        groups: int = 1,
        dilation: int | Sequence[int] = 1,
        bias: bool = False,
        depthwise: bool = False,
        name: Optional[str] = None,
    ) -> str:
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        in_c = self.g.vars[x].shape[-1]
        if depthwise:
            groups = in_c
        w_shape = (kh, kw, in_c // groups, out_channels)  # HWIO
        base = name or self._name("conv")
        w = self.rand_weight(f"{base}.w", w_shape)
        ins = {"Input": [x], "Filter": [w]}
        if bias:
            b = self.weight(f"{base}.b", np.zeros((out_channels,), np.float32))
            ins["Bias"] = [b]
        op_type = "depthwise_conv2d" if depthwise else "conv2d"
        return self.op(
            op_type,
            ins,
            attrs={
                "strides": list((stride, stride) if isinstance(stride, int) else stride),
                "paddings": list((padding, padding) if isinstance(padding, int) else padding),
                "dilations": list((dilation, dilation) if isinstance(dilation, int) else dilation),
                "groups": groups,
            },
            shape_args=[x, w],
            out_slots=("Output",),
            out_name=base,
        )[0]

    def batch_norm(self, x: str, name: Optional[str] = None) -> str:
        c = self.g.vars[x].shape[-1]
        base = name or self._name("bn")
        # non-trivial random stats so conv_bn_fuse correctness is actually
        # exercised by tests (identity stats would hide scale bugs)
        scale = self.weight(f"{base}.scale",
                            (1.0 + 0.1 * self.rng.standard_normal(c)).astype(np.float32))
        bias = self.weight(f"{base}.bias",
                           (0.05 * self.rng.standard_normal(c)).astype(np.float32))
        mean = self.weight(f"{base}.mean",
                           (0.01 * self.rng.standard_normal(c)).astype(np.float32))
        var = self.weight(f"{base}.var",
                          (1.0 + 0.1 * np.abs(self.rng.standard_normal(c))).astype(np.float32))
        return self.op(
            "batch_norm",
            {"X": [x], "Scale": [scale], "Bias": [bias], "Mean": [mean], "Variance": [var]},
            shape_args=[x],
            out_slots=("Y",),
            out_name=base,
        )[0]

    def act(self, x: str, kind: str = "relu", **attrs) -> str:
        return self.op(kind, {"X": [x]}, attrs=attrs, shape_args=[x])[0]

    def conv_bn_act(self, x, out_channels, kernel, stride=1, padding=0,
                    groups=1, act: Optional[str] = "relu",
                    depthwise: bool = False, name: Optional[str] = None) -> str:
        y = self.conv2d(x, out_channels, kernel, stride, padding, groups,
                        depthwise=depthwise, name=name)
        y = self.batch_norm(y)
        if act:
            y = self.act(y, act)
        return y

    def pool2d(self, x: str, ptype: str = "max", ksize=2, stride=2, padding=0,
               global_pooling: bool = False, ceil_mode: bool = False,
               exclusive: bool = True) -> str:
        return self.op(
            "pool2d",
            {"X": [x]},
            attrs={
                "pooling_type": ptype,
                "ksize": list((ksize, ksize) if isinstance(ksize, int) else ksize),
                "strides": list((stride, stride) if isinstance(stride, int) else stride),
                "paddings": list((padding, padding) if isinstance(padding, int) else padding),
                "global_pooling": global_pooling,
                "ceil_mode": ceil_mode,
                "exclusive": exclusive,
            },
            shape_args=[x],
        )[0]

    def fc(self, x: str, out_dim: int, bias: bool = True,
           name: Optional[str] = None) -> str:
        base = name or self._name("fc")
        in_dim = int(np.prod(self.g.vars[x].shape[1:]))
        w = self.rand_weight(f"{base}.w", (in_dim, out_dim),
                             scale=np.sqrt(1.0 / in_dim))
        ins = {"Input": [x], "W": [w]}
        if bias:
            ins["Bias"] = [self.weight(f"{base}.b", np.zeros((out_dim,), np.float32))]
        return self.op("fc", ins, attrs={"in_num_col_dims": 1},
                       shape_args=[x, w], out_name=base)[0]

    def eltwise(self, x: str, y: str, kind: str = "add", axis: int = -1) -> str:
        return self.op(f"elementwise_{kind}", {"X": [x], "Y": [y]},
                       attrs={"axis": axis}, shape_args=[x, y])[0]

    def softmax(self, x: str, axis: int = -1) -> str:
        return self.op("softmax", {"X": [x]}, attrs={"axis": axis},
                       shape_args=[x])[0]

    def reshape(self, x: str, shape: Sequence[int]) -> str:
        return self.op("reshape", {"X": [x]}, attrs={"shape": list(shape)},
                       shape_args=[x])[0]

    def concat(self, xs: Sequence[str], axis: int) -> str:
        return self.op("concat", {"X": list(xs)}, attrs={"axis": axis},
                       shape_args=list(xs))[0]

    def transpose(self, x: str, perm: Sequence[int]) -> str:
        return self.op("transpose", {"X": [x]}, attrs={"axis": list(perm)},
                       shape_args=[x])[0]

    def build(self) -> Graph:
        self.g.rebuild_links()
        return self.g
