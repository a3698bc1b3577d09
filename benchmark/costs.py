"""The benchmark's yardstick for work: peaks of the card and the operations
and bytes of each op of an optimized graph.

Frozen copies, kept here so that a change to the program cannot move them:

- :data:`PEAKS` holds published figures (NVIDIA's H100 SXM data sheet, dense
  rates at 700 W): int8 tensor cores 1,979 TOP/s, HBM 3.35 TB/s, and fp32
  outside the tensor cores as 132 SMs x 128 lanes x 1.98 GHz x 2 operations
  an FMA.  A card that is not in the table has no roofline here.
- :func:`op_cost` is the per-op arithmetic of the program's roofline report
  (``tools/roofline_report._op_cost``): the bytes of every input and output
  at its precision, and a conv's, fc's or matmul's multiply-adds (two
  operations each) at the int8 peak when the op runs int8, else at the fp32
  peak (the port runs float convs with TF32 off).
- :func:`gemm_cost` and :func:`dw_cost` count one launch of the int8 GEMM
  (a conv as its im2col rows: M = N.OH.OW, K = kh.kw.C) and of the int8
  depthwise kernel: each input byte read once, each output byte written once.

The graph is read through its public structure only: ops, their attributes
(``kernel``, ``enable_int8``, ``out_scale``), and the shapes and precisions
of their variables.
"""

from __future__ import annotations

import math
from typing import Dict, List

# name fragment (lower case) -> peaks: operations a second, bytes a second
PEAKS: Dict[str, Dict[str, float]] = {
    "h100 80gb hbm3": {"int8_ops": 1979e12, "fp32_ops": 2 * 132 * 128 * 1.98e9,
                       "hbm_bytes": 3.35e12},
}

BYTES = {"int8": 1, "bf16": 2, "fp16": 2, "fp32": 4, "int32": 4, "int64": 8,
         "bool": 1, "int16": 2}

CONVS = ("conv2d", "depthwise_conv2d", "conv2d_transpose", "fused_dw_pw")


def peaks_for(device_name: str) -> Dict[str, float]:
    low = device_name.lower()
    for key, p in PEAKS.items():
        if key in low:
            return p
    raise KeyError(f"no published peaks for {device_name!r} (known: {sorted(PEAKS)})")


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def var_bytes(graph, name: str) -> int:
    v = graph.vars[name]
    return _numel(v.shape) * BYTES.get(v.precision.value, 4)


def op_cost(graph, op, peaks: Dict[str, float]) -> Dict[str, float]:
    """Bytes, operations, and the op's bound in seconds: the larger of its
    bytes over the memory rate and its operations over its peak."""
    traffic = sum(var_bytes(graph, n) for n in op.input_names())
    traffic += sum(var_bytes(graph, n) for n in op.output_names())
    flops = 0
    if op.op_type in CONVS:
        w = graph.vars[op.input("Filter")].shape
        o = graph.vars[op.output_names()[0]].shape
        flops = 2 * _numel(o) * w[0] * w[1] * w[2]
    elif op.op_type in ("fc", "mul"):
        w = graph.vars[op.input("W" if op.op_type == "fc" else "Y")].shape
        o = graph.vars[op.output_names()[0]].shape
        flops = 2 * _numel(o) * _numel(w[:-1])
    elif op.op_type in ("matmul", "matmul_v2", "bmm"):
        x = graph.vars[op.input("X")].shape
        o = graph.vars[op.output_names()[0]].shape
        k = x[-1] if not op.attrs.get("transpose_X") else x[-2]
        flops = 2 * _numel(o) * int(k)
    peak = peaks["int8_ops"] if flops and op.attrs.get("enable_int8") else peaks["fp32_ops"]
    compute_s = flops / peak
    return {"bytes": traffic, "flops": flops, "compute_s": compute_s,
            "bound_s": max(traffic / peaks["hbm_bytes"], compute_s)}


def gemm_mkn(graph, op):
    """(M, K, N) of an fc / mul / conv the int8 GEMM runs."""
    if op.op_type == "conv2d":
        kh, kw, c, oc = graph.vars[op.input("Filter")].shape
        n, oh, ow, _ = graph.vars[op.output("Output")].shape
        return n * oh * ow, kh * kw * c, oc
    if op.op_type == "fc":
        x = graph.vars[op.input("Input")].shape
        ncd = int(op.attrs.get("in_num_col_dims", len(x) - 1))
        k, n = graph.vars[op.input("W")].shape
        return _numel(x[:ncd]), k, n
    x, w = graph.vars[op.input("X")].shape, graph.vars[op.input("Y")].shape
    xd, yd = int(op.attrs.get("x_num_col_dims", 1)), int(op.attrs.get("y_num_col_dims", 1))
    return _numel(x[:xd]), _numel(x[xd:]), _numel(w[yd:])


def gemm_cost(graph, op, peaks: Dict[str, float]) -> float:
    """Bound seconds of one GEMM launch: A (M x K int8), B (K x N int8), the
    per-channel scales and the bias (fp32) read once, C written once (int8
    with a requant, else fp32)."""
    m, k, n = gemm_mkn(graph, op)
    out = 1 if op.attrs.get("out_scale") is not None else 4
    nbytes = m * k + k * n + 4 * n * (2 if op.maybe_input("Bias") else 1) + m * n * out
    return max(2 * m * k * n / peaks["int8_ops"], nbytes / peaks["hbm_bytes"])


def dw_cost(graph, op, peaks: Dict[str, float]) -> float:
    """Bound seconds of one int8 depthwise launch."""
    kh, kw, _, c = graph.vars[op.input("Filter")].shape
    o = graph.vars[op.output_names()[0]].shape
    out = 1 if op.attrs.get("out_scale") is not None else 4
    nbytes = (_numel(graph.vars[op.input("Input")].shape) + kh * kw * c
              + 4 * c * (2 if op.maybe_input("Bias") else 1) + _numel(o) * out)
    return max(2 * _numel(o) * kh * kw / peaks["int8_ops"], nbytes / peaks["hbm_bytes"])


def routed(graph, op_types) -> List:
    """The ops of `op_types` that the optimized graph hands to a kernel of
    the port (``kernel == "cuda"``), in graph order."""
    return [op for op in graph.topological_order()
            if op.op_type in op_types and op.attrs.get("kernel") == "cuda"]


def step_costs(graph, peaks: Dict[str, float]) -> Dict[str, float]:
    """One call of the graph: the sum over its ops of their compute time at
    peak (``compute_s``) and of their bounds (``bound_s``)."""
    costs = [op_cost(graph, op, peaks) for op in graph.topological_order()]
    return {"compute_s": sum(c["compute_s"] for c in costs),
            "bound_s": sum(c["bound_s"] for c in costs),
            "flops": sum(c["flops"] for c in costs)}
