"""Quantization graph passes.

Copy of ``paddle_lite_tpu/quant/quantize_pass.py`` (numpy only), the
weight-only storage mode (:func:`weight_only_quantize`) included.  The op
lists come from this package's ``calibrate`` (the reference's imports jax,
``quantize_pass.py:33``).  Together these are the quantization machinery of
the MIR pipeline:

- :func:`apply_quantization` — the core rewrite shared by PTQ and QAT-import:
  per-channel int8 weights + per-tensor activation scales stamped onto graph
  vars, ops marked ``enable_int8`` (mirrors ``quant_dequant_fuse_pass``
  stamping ``input_scale``/``weight_scale``/``enable_int8`` onto conv/fc/mul)
  and int8 regions assigned (which edges carry int8 tensors, which op outputs
  get a fused requant — the role of ``static_kernel_pick_pass`` +
  ``variable_place_inference_pass`` choosing int8-out vs fp-out kernel
  aliases).
- ``precision_cast`` pass — inserts explicit ``quantize`` nodes where an fp32
  edge feeds an int8 kernel (``type_precision_cast_pass`` inserting `calib`
  ops).  Dequant never needs an inserted node: every op impl inline-dequants
  int8 operands.
- ``quant_dequant_fuse`` pass — consumes imported QAT graphs containing
  ``fake_quantize_*`` / ``fake_dequantize_*`` ops, deletes the fake ops and
  reuses :func:`apply_quantization` with their recorded scales.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.ir import Graph, OpNode
from ..core.pass_manager import register_pass
from ..core.types import CalibMethod, Precision, QuantInfo
from .calibrate import (CalibrationResult, PASSTHROUGH_OPS, QUANTIZABLE_OPS,
                        TRANSPARENT_OPS)


@dataclasses.dataclass
class QuantConfig:
    """Quantization scheme config (QuantConfig analog of CxxConfig's quant
    options + PaddleSlim's strategy knobs).  The same fields and defaults
    as the JAX package's; ``tools/opt.optimize`` runs every option the
    JAX package runs, and raises ``NotImplementedError`` for an
    ``island_dtype`` other than ``"float32"`` and ``"bfloat16"``."""

    method: CalibMethod = CalibMethod.ABS_MAX
    per_channel_weights: bool = True
    # int8 for activation x activation matmuls (attention); off by default
    quant_act_act_matmul: bool = False
    # True: all depthwise convs int8; False: none; an int: only those with
    # <= that many channels
    quant_depthwise: object = True
    # compute dtype the JAX package uses for int8 depthwise ("int32" |
    # "bf16"); both give the identical accumulator, so the port ignores it
    depthwise_compute: str = "int32"
    # dtype of the non-int8 float regions ("float32" | "bfloat16")
    island_dtype: str = "float32"
    skip_ops: Sequence[str] = ()  # op output-var names to keep fp32
    observer_kwargs: Optional[dict] = None
    bins: int = 2048
    # E[(W - W_q)·x] bias compensation; default off
    bias_correction: bool = False
    # int8 1x1/s1/group-1 convs as reshape + dot; default off
    conv1x1_dot: bool = False
    # fuse dw + pw int8 blocks into one kernel (ops/fused.py there)
    fuse_dw_pw: bool = False
    # weight-only storage quantization (4, 8 or 16 bits), calibration-free
    weight_only: Optional[int] = None
    # keep the stem conv (graph-input data, <=4 channels) in float
    skip_stem_conv: bool = True
    # int8 ops with a fused gelu use the tanh approximation
    gelu_approximate: bool = True


_WEIGHT_AXIS = {  # per-channel axis = output-channel axis of the weight
    "conv2d": 3,  # HWIO
    "depthwise_conv2d": 3,
    "fc": 1,  # (K, O)
    "mul": 1,
    "matmul": -1,
}

_DATA_SLOTS = {
    "conv2d": ("Input",),
    "depthwise_conv2d": ("Input",),
    "fc": ("Input",),
    "mul": ("X",),
    "matmul": ("X", "Y"),
    "fused_dw_pw": ("Input",),
}

_WEIGHT_SLOTS = {
    "conv2d": "Filter",
    "depthwise_conv2d": "Filter",
    "fc": "W",
    "mul": "Y",
    "matmul": "Y",
}


def quantize_weight_per_channel(w: np.ndarray, axis: int):
    """Symmetric per-channel int8: returns (q, scale) with
    scale[c] = absmax_c / 127 and q = clip(round(w / scale))."""
    axis = axis % w.ndim
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.maximum(np.abs(w).max(axis=red), 1e-10).astype(np.float32)
    scale = amax / 127.0
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale


def quantize_weight_per_tensor(w: np.ndarray):
    amax = np.float32(max(np.abs(w).max(), 1e-10))
    q = np.clip(np.round(w / amax * 127.0), -127, 127).astype(np.int8)
    return q, amax / 127.0


def _is_quantizable(graph: Graph, op: OpNode, config: QuantConfig) -> bool:
    if op.op_type not in QUANTIZABLE_OPS:
        return False
    if op.op_type == "depthwise_conv2d" and config.quant_depthwise is not True:
        # quant_depthwise: True = all, False = none, int = only dw whose
        # channel count is <= the threshold.
        limit = int(config.quant_depthwise)  # False -> 0
        if graph.vars[op.input("Input")].shape[3] > limit:
            return False
    if op.op_type == "conv2d" and config.skip_stem_conv:
        # Stem convs (graph-input data, <=4 channels) stay float: K = k*k*C
        # is tiny (27 for an RGB 3x3), so int8 buys little, while its
        # output is still requantized for the int8 trunk.  The reference
        # ran the first conv fp32 in many int8 deployments. The walk looks through
        # transparent producers (the fluid importer's NCHW->NHWC transpose
        # sits between the input and the stem); in-channels come from the
        # conv's own filter (HWIO I x groups), which is layout-independent.
        w_shape = graph.vars[op.input(_WEIGHT_SLOTS["conv2d"])].shape
        in_ch = w_shape[2] * int(op.attrs.get("groups", 1))
        if in_ch <= 4:
            x = op.maybe_input("Input")
            seen = 0
            while x is not None and seen < 8:
                v = graph.vars[x]
                if v.is_weight:
                    break
                if v.def_op is None:
                    return False  # stem: graph-input data, <=4 channels
                if v.def_op.op_type in TRANSPARENT_OPS or \
                        v.def_op.op_type == "space_to_depth":
                    x = v.def_op.input_names()[0]
                    seen += 1
                else:
                    break
    if any(n in config.skip_ops for n in op.output_names()):
        return False
    w_slot = _WEIGHT_SLOTS[op.op_type]
    w_name = op.maybe_input(w_slot)
    if w_name is None:
        return False
    if graph.vars[w_name].is_weight:
        return True
    # activation×activation matmul (attention scores / context)
    return op.op_type == "matmul" and config.quant_act_act_matmul


def _propagate_scale(graph: Graph, name: str,
                     act_scales: Dict[str, float]) -> Optional[float]:
    """Scale for `name`, walking up through scale-preserving ops.

    QAT imports record scales on the fluid-named vars; layout casts the
    converter inserted (transpose to NHWC) sit between those names and the
    quantizable op's actual inputs. Transparent ops preserve the scale
    exactly, so propagate it down (memoized into act_scales)."""
    if name in act_scales:
        return act_scales[name]
    seen = set()
    chain = [name]
    cur = name
    while cur not in act_scales:
        if cur in seen:
            return None
        seen.add(cur)
        d = graph.vars[cur].def_op
        if d is None or d.op_type not in TRANSPARENT_OPS:
            return None
        cur = d.input_names()[0]
        chain.append(cur)
    s = act_scales[cur]
    for n in chain:
        act_scales[n] = s
    return s


def apply_quantization(
    graph: Graph,
    act_scales: Dict[str, float],
    config: Optional[QuantConfig] = None,
    weight_scales: Dict[str, np.ndarray] = None,
) -> None:
    """Core quantization rewrite. ``act_scales`` come from calibration (PTQ)
    or from imported fake-quant ops (QAT, via ``weight_scales`` too)."""
    config = config or QuantConfig()
    weight_scales = weight_scales or {}

    int8_ops: List[OpNode] = []
    for op in graph.ops:
        if not _is_quantizable(graph, op, config):
            continue
        # ---- weights -> per-channel int8 -------------------------------
        w_name = op.input(_WEIGHT_SLOTS[op.op_type])
        w_var = graph.vars[w_name]
        if w_var.is_weight and w_var.precision != Precision.INT8:
            w = graph.weights[w_name]
            axis = _WEIGHT_AXIS[op.op_type] % w.ndim
            if w_name in weight_scales:
                scales = np.asarray(weight_scales[w_name], np.float32) / 127.0
                shape = [1] * w.ndim
                shape[axis] = -1
                q = np.clip(np.round(w / scales.reshape(shape)), -127, 127).astype(np.int8)
            elif config.per_channel_weights:
                q, scales = quantize_weight_per_channel(w, axis)
            else:
                q, s = quantize_weight_per_tensor(w)
                scales = np.array([s] * w.shape[axis], np.float32)
            graph.weights[w_name] = q
            w_var.ttype = dataclasses.replace(w_var.ttype, precision=Precision.INT8)
            w_var.quant = QuantInfo.per_channel_scales(scales, axis)
        # ---- activation scales on adjacent vars ------------------------
        missing = False
        for slot in _DATA_SLOTS[op.op_type]:
            n = op.maybe_input(slot)
            if n is None or graph.vars[n].is_weight:
                continue
            if _propagate_scale(graph, n, act_scales) is None:
                missing = True
                continue
            if graph.vars[n].quant is None:
                graph.vars[n].quant = QuantInfo.per_tensor(act_scales[n])
        if missing:
            continue  # cannot run this op in int8 without an input scale
        for n in op.output_names():
            if n in act_scales and graph.vars[n].quant is None:
                graph.vars[n].quant = QuantInfo.per_tensor(act_scales[n])
        op.attrs["enable_int8"] = True
        if op.op_type == "depthwise_conv2d":
            op.attrs["dw_compute"] = config.depthwise_compute
        if (config.gelu_approximate
                and op.attrs.get("fuse_act") == "gelu"):
            op.attrs["act_attrs"] = dict(op.attrs.get("act_attrs") or {},
                                         approximate=True)
        int8_ops.append(op)

    _assign_int8_regions(graph, act_scales)


def _gate_mul_data_slot(graph: Graph, op: OpNode):
    """If `op` is an SE-style gated multiply — elementwise_mul whose one
    operand is a [0, 1] gate (sigmoid / hard_sigmoid output, possibly fused
    into a conv epilogue) — return the DATA operand's slot, else None.
    A gate <= 1 means |x*g| <= |x|, so the data operand's int8 scale remains
    valid through the multiply and the whole op fuses into one elementwise
    kernel (int8 in -> int8 out, no fp32 HBM round trip)."""
    if op.op_type != "elementwise_mul":
        return None

    def is_gate(name):
        d = graph.vars[name].def_op
        if d is None:
            return False
        if d.op_type in ("sigmoid", "hard_sigmoid"):
            return True
        return d.attrs.get("fuse_act") in ("sigmoid", "hard_sigmoid")

    x, y = op.input("X"), op.input("Y")
    if is_gate(y) and not is_gate(x):
        return "X"
    if is_gate(x) and not is_gate(y):
        return "Y"
    return None


def _consumers_accept_int8(graph: Graph, var_name: str, memo: dict) -> bool:
    """True iff every consumer of `var_name` consumes int8 natively: an
    enable_int8 op's data slot, a passthrough op whose own output is
    int8-consumable downstream, or a gated multiply's data operand.
    Graph outputs must stay fp32."""
    if var_name in memo:
        return memo[var_name]
    memo[var_name] = False  # cycle guard
    if var_name in graph.outputs:
        return False
    v = graph.vars[var_name]
    if not v.use_ops:
        return False
    for op in v.use_ops:
        if op.attrs.get("enable_int8"):
            slots = _DATA_SLOTS.get(op.op_type, ())
            in_data = any(op.maybe_input(s) == var_name for s in slots)
            is_residual = op.maybe_input("ResidualData") == var_name
            if not (in_data or is_residual):
                # bias operands want fp32
                return False
            # residual operands are fine as int8: the conv epilogue
            # inline-dequantizes them, and int8 shortcut
            # edges carry 4x less HBM traffic through a ResNet stage
        elif op.op_type in PASSTHROUGH_OPS or op.op_type == "concat":
            # concat is conditionally int8: the kernel requants every input
            # to a common (max) scale in-register, so it accepts int8 iff
            # its own consumers do (the reference's int8 concat kernel,
            # lite/kernels/arm/concat_compute.cc with requant)
            ok = all(
                _consumers_accept_int8(graph, out, memo)
                for out in op.output_names()
            )
            if not ok:
                return False
        elif _gate_mul_data_slot(graph, op) is not None:
            # int8 acceptable only on the data operand (the eltwise impl
            # dequantizes in-register); the gate operand must stay fp
            if op.input(_gate_mul_data_slot(graph, op)) != var_name:
                return False
        else:
            return False
    memo[var_name] = True
    return True


def _assign_int8_regions(graph: Graph, act_scales: Dict[str, float]) -> None:
    """Decide which edges carry int8 tensors.

    An enable_int8 op's output becomes int8 (fused requant: ``out_scale``
    stamped on the op) iff all transitive consumers accept int8; passthrough
    ops then propagate precision AND scale (pool/reshape preserve scale
    exactly) along the chain.
    """
    memo: dict = {}
    for op in graph.topological_order():
        if op.attrs.get("enable_int8") or (
                # float matmul-family ops (e.g. the skip_stem_conv stem)
                # still write int8 when everything downstream is int8: the
                # epilogue's fused quantize turns a 4x fp32 HBM write into
                # an int8 one (decisive for wide stems like ResNet's 64ch)
                op.op_type in QUANTIZABLE_OPS
                and _WEIGHT_SLOTS.get(op.op_type)
                and op.maybe_input(_WEIGHT_SLOTS[op.op_type]) is not None):
            out_name = op.output_names()[0]
            if out_name in act_scales and _consumers_accept_int8(graph, out_name, memo):
                out_var = graph.vars[out_name]
                op.attrs["out_scale"] = float(act_scales[out_name])
                out_var.quant = QuantInfo.per_tensor(act_scales[out_name])
                out_var.ttype = dataclasses.replace(
                    out_var.ttype, precision=Precision.INT8
                )
        elif op.op_type in PASSTHROUGH_OPS:
            in_name = op.input_names()[0]
            in_var = graph.vars[in_name]
            if in_var.precision == Precision.INT8 and not in_var.is_weight:
                for out_name in op.output_names():
                    out_var = graph.vars[out_name]
                    out_var.quant = in_var.quant  # scale-preserving
                    out_var.ttype = dataclasses.replace(
                        out_var.ttype, precision=Precision.INT8
                    )
        elif op.op_type == "concat":
            # int8 concat: when every input arrives int8 and downstream
            # accepts int8, emit int8 at the max input scale — each input
            # requants by s_in/s_out <= 1 in-register,
            # no fp32 materialization of the concatenated map.  Mixed or
            # fp-consumer cases keep the fp32 path (kernel dequantizes).
            in_vars = [graph.vars[n] for n in op.input_names()]
            out_name = op.output_names()[0]
            if (all(v.precision == Precision.INT8 and v.quant is not None
                    and not v.is_weight for v in in_vars)
                    and _consumers_accept_int8(graph, out_name, memo)):
                scale = max(float(v.quant.scale[0]) for v in in_vars)
                op.attrs["out_scale"] = scale
                out_var = graph.vars[out_name]
                out_var.quant = QuantInfo.per_tensor(scale)
                out_var.ttype = dataclasses.replace(
                    out_var.ttype, precision=Precision.INT8
                )
        elif (slot := _gate_mul_data_slot(graph, op)) is not None:
            # SE gated multiply: int8 data in -> int8 out (one fused kernel)
            in_var = graph.vars[op.input(slot)]
            out_name = op.output_names()[0]
            if (in_var.precision == Precision.INT8
                    and in_var.quant is not None
                    and _consumers_accept_int8(graph, out_name, memo)):
                # prefer the calibrated post-gate scale (gating shrinks the
                # range -> finer quanta); fall back to the input's scale,
                # which stays valid because the gate is <= 1
                scale = float(act_scales.get(out_name,
                                             in_var.quant.scale[0]))
                op.attrs["out_scale"] = scale
                out_var = graph.vars[out_name]
                out_var.quant = QuantInfo.per_tensor(scale)
                out_var.ttype = dataclasses.replace(
                    out_var.ttype, precision=Precision.INT8
                )


@register_pass("precision_cast")
def precision_cast(graph: Graph) -> None:
    """Insert explicit ``quantize`` nodes on fp32→int8-kernel edges
    (type_precision_cast_pass inserting calib ops).  One cast per source var
    is shared by all consumers (`calib_once` behavior)."""
    quantized_of: Dict[str, str] = {}
    for op in list(graph.ops):
        if not op.attrs.get("enable_int8"):
            continue
        for slot in _DATA_SLOTS.get(op.op_type, ()):
            n = op.maybe_input(slot)
            if n is None:
                continue
            v = graph.vars[n]
            if v.is_weight or v.precision == Precision.INT8:
                continue
            if v.quant is None:
                continue  # no scale recorded; op impl will stay fp32 for it
            if n not in quantized_of:
                qname = graph.unique_name(n + ".q8")
                qv = graph.add_var(qname, v.shape, precision=Precision.INT8)
                qv.quant = v.quant
                graph.add_op("quantize", {"X": [n]}, {"Out": [qname]})
                quantized_of[n] = qname
            op.inputs[slot] = [quantized_of[n]]
    graph.rebuild_links()


@register_pass("quant_dequant_fuse")
def quant_dequant_fuse(graph: Graph) -> None:
    """Consume imported QAT graphs: delete ``fake_quantize_*`` /
    ``fake_dequantize_*`` ops, collect their scales, then apply the shared
    quantization rewrite (quant_dequant_fuse_pass + quant_dequant_op_fuser).
    """
    FAKE_Q = (
        "fake_quantize_abs_max",
        "fake_quantize_range_abs_max",
        "fake_quantize_moving_average_abs_max",
        "fake_quantize_dequantize_moving_average_abs_max",
        "fake_quantize_dequantize_abs_max",
    )
    FAKE_DQ = ("fake_dequantize_max_abs", "fake_channel_wise_dequantize_max_abs")

    act_scales: Dict[str, float] = {}
    weight_scales: Dict[str, np.ndarray] = {}
    dead: List[OpNode] = []

    def _weight_absmax_channels(x: str, w_arr: np.ndarray):
        """(axis, channels) of a quantizable consumer's weight slot."""
        consumer = next(
            (c for c in graph.vars[x].use_ops
             if c.op_type in _WEIGHT_SLOTS
             and c.maybe_input(_WEIGHT_SLOTS[c.op_type]) == x),
            None)
        axis = (_WEIGHT_AXIS[consumer.op_type] if consumer is not None
                else -1) % w_arr.ndim
        return axis, w_arr.shape[axis]

    for op in list(graph.ops):
        if op.op_type in FAKE_Q:
            x = op.input("X")
            out = op.output("Out")
            # scale recorded as attr or as an InScale weight (range variant);
            # paddle stores the abs-max *threshold* (scale*127)
            if "scale" in op.attrs:
                s = float(op.attrs["scale"]) / 127.0
            elif op.maybe_input("InScale"):
                s = float(np.asarray(
                    graph.weights[op.input("InScale")]).reshape(-1)[0]) / 127.0
            else:
                s = None
            if s is not None and s <= 0.0:
                s = None  # a 0.0 threshold is a training artifact, not a scale
            v = graph.vars[x]
            if v.is_weight:
                w_arr = graph.weights[x]
                axis, ch = _weight_absmax_channels(x, w_arr)
                if s is not None:
                    # per-tensor recorded scale: expand to the channel width
                    # the per-channel rewrite expects
                    weight_scales[x] = np.full(ch, s * 127.0, np.float32)
                else:
                    # missing/zero recorded scale: repair from the weight
                    # itself (the weight_quantization_preprocess_pass role)
                    red = tuple(i for i in range(w_arr.ndim) if i != axis)
                    weight_scales[x] = np.maximum(
                        np.abs(w_arr).max(axis=red), 1e-10).astype(np.float32)
            elif s is not None:
                act_scales[x] = s
                act_scales[out] = s
            dead.append(op)
            graph.replace_var_uses(out, x)
        elif op.op_type in FAKE_DQ:
            x = op.input("X")
            out = op.output("Out")
            if op.maybe_input("Scales"):
                sc = np.asarray(graph.weights[op.input("Scales")],
                                np.float32).reshape(-1)
                producer = graph.vars[x].def_op
                if producer is not None:
                    w_slot = _WEIGHT_SLOTS.get(producer.op_type)
                    if w_slot and producer.maybe_input(w_slot):
                        w_name = producer.input(w_slot)
                        if np.any(sc <= 0):
                            # repair zero/negative recorded thresholds from
                            # the weight itself (per-channel abs-max)
                            w_arr = graph.weights[w_name]
                            axis = _WEIGHT_AXIS[producer.op_type] % w_arr.ndim
                            red = tuple(i for i in range(w_arr.ndim)
                                        if i != axis)
                            repair = np.maximum(
                                np.abs(w_arr).max(axis=red), 1e-10)
                            sc = np.where(sc > 0, sc,
                                          repair.astype(np.float32))
                        weight_scales[w_name] = sc
            if "max_range" in op.attrs:
                producer = graph.vars[x].def_op
                if producer is not None:
                    w_slot = _WEIGHT_SLOTS.get(producer.op_type)
                    if w_slot and producer.maybe_input(w_slot):
                        w = graph.weights[producer.input(w_slot)]
                        amax = 127.0 * 127.0 / float(op.attrs["max_range"])
                        weight_scales[producer.input(w_slot)] = np.asarray(
                            [amax] * w.shape[_WEIGHT_AXIS[producer.op_type] % w.ndim]
                        )
            dead.append(op)
            graph.replace_var_uses(out, x)

    if dead:
        graph.remove_ops(dead)
        weight_scales = {k: v for k, v in weight_scales.items() if v is not None}
        # QAT graphs quantize what training quantized: the skip_stem_conv
        # perf heuristic is a PTQ-placement decision and must not override
        # recorded fake-quant placement (ops without recorded scales are
        # naturally skipped by the missing-scale check).
        apply_quantization(graph, act_scales, weight_scales=weight_scales,
                           config=QuantConfig(skip_stem_conv=False))


def ptq_quantize(
    graph: Graph,
    calib: CalibrationResult,
    config: Optional[QuantConfig] = None,
) -> None:
    """PTQ entry: apply quantization with calibrated activation scales."""
    apply_quantization(graph, calib.scales, config=config)


def weight_only_quantize(graph: Graph, bits: int = 8) -> int:
    """Calibration-free weight-only quantization (``SaveModelNaive``'s
    quantize-on-save, lite/model_parser/model_parser.cc + the
    weight_quantization_preprocess pass).

    Stores conv/fc/mul/matmul weights as packed int4 pairs (bits=4,
    riding int8 containers — see core/types.QuantInfo.pack_axis), int8
    (bits=8), or int16 (bits=16) with per-output-channel scales;
    activations stay float and the op impls inline-dequantize the weight
    (``ops/common.maybe_dequant_mixed``) on every run, so the narrow weight
    is what stays resident. No ``enable_int8`` marking — this is a
    storage/bandwidth mode, not the int8 kernel path.
    A bits=4 weight with no even-length non-scale axis to pack along
    (e.g. an RGB stem's 3-channel input axis with odd kernel dims) falls
    back to int8 storage for that weight. Returns the number of weights
    quantized.
    """
    if bits not in (4, 8, 16):
        raise ValueError(f"weight_only bits must be 4, 8 or 16, got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    dtype = np.int8 if bits <= 8 else np.int16
    prec = Precision.INT8 if bits <= 8 else Precision.INT16
    n = 0
    for op in graph.ops:
        w_slot = _WEIGHT_SLOTS.get(op.op_type)
        if w_slot is None:
            continue
        w_name = op.maybe_input(w_slot)
        if w_name is None:
            continue
        w_var = graph.vars[w_name]
        if not w_var.is_weight or w_var.quant is not None:
            continue
        w = graph.weights[w_name]
        if w.dtype != np.float32:
            continue
        axis = _WEIGHT_AXIS[op.op_type] % w.ndim
        eff_bits, pack_axis = bits, None
        if bits == 4:
            pack_axis = next(
                (i for i in range(w.ndim)
                 if i != axis and w.shape[i] % 2 == 0), None)
            if pack_axis is None:
                eff_bits = 8  # nothing even to pack along — int8 fallback
        eff_qmax = float(2 ** (eff_bits - 1) - 1)
        red = tuple(i for i in range(w.ndim) if i != axis)
        amax = np.maximum(np.abs(w).max(axis=red), 1e-10).astype(np.float32)
        scale = amax / eff_qmax
        shape = [1] * w.ndim
        shape[axis] = -1
        q = np.clip(np.round(w / scale.reshape(shape)), -eff_qmax,
                    eff_qmax).astype(dtype)
        if eff_bits == 4:
            lo = np.take(q, np.arange(0, q.shape[pack_axis], 2), pack_axis)
            hi = np.take(q, np.arange(1, q.shape[pack_axis], 2), pack_axis)
            q = ((lo & 0xF) | (hi << 4)).astype(np.int8)
        graph.weights[w_name] = q
        w_var.ttype = dataclasses.replace(w_var.ttype, precision=prec)
        w_var.quant = QuantInfo(scale=tuple(float(s) for s in scale),
                                axis=axis, bits=eff_bits,
                                pack_axis=pack_axis if eff_bits == 4
                                else None)
        n += 1
    return n
