"""Cross-checks between the ``"cuda"`` kernels and the plain ``"torch"`` ops
on one optimized graph, used by ``chip_smoke.py`` and the CPU tests.

The two tags compute the same int8 layers with one difference, inherited
from the JAX package: the kernels requantize with ``y * fp32(1/s)`` (the
Pallas epilogue, ``int8_matmul.py:38`` there), the torch ops with ``y / s``
(the XLA path, ``common.py:107`` there).  The two round differently only
where ``y / s`` sits on a rounding tie, so, fed the same inputs, an op's
outputs may differ by 1 LSB in a tiny fraction of elements.  Run end to end,
such a flip changes the next layers' inputs and spreads, so end-to-end int8
tensors are not held to that bound; :func:`op_local_diffs` feeds every op
the inputs the kernel run gave it.

The fused dw+pw op is the exception: its ``"torch"`` form requantizes the
internal depthwise output by division and its kernel by the reciprocal, and
one tie there moves the pointwise output by more than 1 LSB.  So
:func:`fused_local_diffs` holds the fused kernel to the unfused pair of
kernels and to its plain version instead, bit for bit.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import torch

from .core.executor import ExecutionContext, build_callable
from .core.ir import Graph
from .core.registry import OPS

# an op fed identical inputs: at most this fraction of its int8 outputs
# (or TIE_COUNT elements, for small tensors) may differ, each by at most
# TIE_LSB (rounding ties of y*(1/s) vs y/s; about 1e-6 of elements)
TIE_FRACTION = 1e-4
TIE_COUNT = 2
TIE_LSB = 1
# the model's softmax output, end to end
SOFTMAX_ATOL = 1e-3
# ops whose "torch" impl computes another function than their "cuda" impl,
# as in the reference: multiclass_nms under "torch" maps the bucket
# candidate tiers to an exact top-k and tests ``iou > t`` by division
# (``detection.py:271,303,373-379`` there), so its outputs are not compared
OTHER_FUNCTION = ("multiclass_nms", "multiclass_nms2")
# ops held to the unfused kernels instead of their "torch" impl
HELD_TO_UNFUSED = ("fused_dw_pw",)


def retag(graph: Graph, src: str, dst: str) -> Graph:
    """A copy of `graph` with every op tagged `src` tagged `dst`."""
    g = copy.deepcopy(graph)
    for op in g.ops:
        if op.attrs.get("kernel") == src:
            op.attrs["kernel"] = dst
    return g


def capture_all(graph: Graph, weights: Dict[str, torch.Tensor],
                feed: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """Run `graph` and return every graph input and op output by name."""
    env: Dict[str, torch.Tensor] = {}
    build_callable(graph, device=device,
                   capture=lambda n, v: env.__setitem__(n, v))(weights, feed)
    return env


def op_local_diffs(graph: Graph, weights: Dict[str, torch.Tensor],
                   feed: Dict[str, Any], device: torch.device,
                   kernel: str = "cuda") -> List[dict]:
    """Run `graph`; then, for every op tagged `kernel` except those in
    :data:`OTHER_FUNCTION` and :data:`HELD_TO_UNFUSED`, run its ``"torch"``
    impl on the very inputs it got and compare outputs.  Under bf16 islands
    the run's fp32 outputs were rounded to bf16 by the executor, so the
    torch impl's are rounded the same way first.  Returns one record per
    output: {"op", "var", "numel", "n_diff", "max_diff"}."""
    env = capture_all(graph, weights, feed, device)
    env.update(weights)
    ctx = ExecutionContext(graph=graph, device=device)
    out = []
    for op in graph.topological_order():
        if (op.attrs.get("kernel") != kernel
                or op.op_type in OTHER_FUNCTION + HELD_TO_UNFUSED):
            continue
        ins = {s: [env[n] for n in ns] for s, ns in op.inputs.items() if ns}
        ref = OPS.get(op.op_type).impls["torch"](ctx, op, ins)
        for slot, arrs in ref.items():
            for name, r in zip(op.outputs[slot], arrs):
                if r.dtype == torch.float32 and env[name].dtype != r.dtype:
                    r = r.to(env[name].dtype)  # the executor's island rounding
                out.append(dict(_diff(env[name], r), op=op.op_type, var=name))
    return out


def _diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    return {"numel": d.numel(), "n_diff": int((d > 0).sum()),
            "max_diff": float(d.max()) if d.numel() else 0.0}


def fused_local_diffs(graph: Graph, weights: Dict[str, torch.Tensor],
                      feed: Dict[str, Any], device: torch.device) -> List[dict]:
    """Run `graph`; then hold every ``"cuda"`` ``fused_dw_pw`` op's output,
    on the input it got, to the unfused pair of kernels (depthwise, then
    the GEMM: ``against="unfused"``) and to the fused kernel's plain
    version (``against="plain"``).  Records as :func:`op_local_diffs`
    gives, plus "against"; both must have no difference."""
    from .ops.fused import block_scales
    from .ops.kernels import depthwise, dw_pw_fused, int8_matmul

    env = capture_all(graph, weights, feed, device)
    env.update(weights)
    ctx = ExecutionContext(graph=graph, device=device)
    out = []
    for op in graph.topological_order():
        if op.op_type not in HELD_TO_UNFUSED or op.attrs.get("kernel") != "cuda":
            continue
        a = op.attrs
        x, dw_w, pw_w = (env[op.input(s)] for s in ("Input", "DwFilter", "PwFilter"))
        dw_b = env[op.input("DwBias")] if op.maybe_input("DwBias") else None
        pw_b = env[op.input("PwBias")] if op.maybe_input("PwBias") else None
        dw_eff, pw_eff = block_scales(ctx, op)
        n, h, w, c = x.shape
        d = depthwise.dw_conv_int8(x, dw_w, dw_eff, dw_b, stride=1,
                                   act=a.get("dw_act"), act_attrs=a.get("dw_act_attrs"),
                                   out_scale=a["dw_out_scale"])
        pair = int8_matmul.int8_matmul(
            d.reshape(n * h * w, c), pw_w.reshape(c, -1), pw_eff, pw_b,
            act=a.get("pw_act"), act_attrs=a.get("pw_act_attrs"),
            out_scale=a.get("out_scale")).reshape(n, h, w, -1)
        plain = dw_pw_fused.fused_dw_pw_int8_plain(
            x, dw_w, dw_eff, dw_b, a["dw_out_scale"], pw_w, pw_eff, pw_b,
            dw_act=a.get("dw_act"), dw_act_attrs=a.get("dw_act_attrs"),
            pw_act=a.get("pw_act"), pw_act_attrs=a.get("pw_act_attrs"),
            pw_out_scale=a.get("out_scale"))
        name = op.output("Output")
        for against, ref in (("unfused", pair), ("plain", plain)):
            out.append(dict(_diff(env[name], ref), op=op.op_type, var=name,
                            against=against))
    return out


def within_tie_bound(diffs: List[dict]) -> bool:
    return all(d["max_diff"] <= TIE_LSB
               and d["n_diff"] <= max(TIE_COUNT, TIE_FRACTION * d["numel"])
               for d in diffs)
