"""Analytic per-op roofline report — the roofline-calculator half of the
profiling story.

Port of ``paddle_lite_tpu/tools/roofline_report.py``: for every op of an
optimized graph, the memory bound (the bytes of its inputs and outputs at
their precisions, over the card's memory rate) and the compute bound (a
conv's / fc's / matmul's multiply-adds, two operations each, over the peak
of its operand type), the larger one binding, and the model's sum.  Joined
with a measured per-op profile (``tools/profile.latency_report`` JSONL) it
shows how far each op sits from its ceiling.

    python -m paddle_lite_tpu_torch.tools.roofline_report --model mobilenet_v1 \\
        --batch 64 [--profile profile_mobilenet_v1.jsonl] [--fp32] [--per-op] \\
        [--device cpu]

The command calibrates and optimizes the graph on the card and takes the
card's own peaks (``device_info.get().specs``); ``--device cpu`` does the
analysis on a machine with no card, against the H100's table entry (the
port's card).  ``roofline_report`` itself takes the H100's figures unless
given ``specs``.  The peaks are ``utils/device_info``'s.  int8 ops take the int8 tensor-core
rate; other ops the bf16 rate under bf16 islands, else the fp32 rate
outside the tensor cores (two operations an FMA instruction), since the
port runs fp32 convs and matmuls with TF32 off.  The reference's ``tiled``
option (``_tiled_elems``, ``_SUBLANES``, ``:49-66`` there) counts bytes at
the TPU's (8, 128) tile padding; memory on this card has no such layout,
so it has no analog here and is left out.

Model caveat (the reference's): per-op traffic assumes every edge goes
through device memory, so the sum is pessimistic where ops fuse, while
each row is optimistic (no relayouts, perfect utilization).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np

from ..core.ir import Graph
from ..core.types import Precision
from ..utils import device_info

_BYTES = {Precision.INT8: 1, Precision.BF16: 2, Precision.FP16: 2,
          Precision.FP32: 4, Precision.INT32: 4, Precision.INT64: 8,
          Precision.BOOL: 1, Precision.INT16: 2}

H100 = device_info.SPECS["h100 80gb hbm3"]


def _peaks(specs: Dict[str, float], island_bf16: bool):
    """(bytes/s, int8 op/s, other ops' op/s)."""
    other = (specs["bf16_tflops"] * 1e12 if island_bf16
             else 2 * specs["fp32_tinstrs"] * 1e12)
    return specs["hbm_gbps"] * 1e9, specs["int8_tops"] * 1e12, other


def _op_cost(graph: Graph, op, island_bf16: bool, specs: Dict[str, float] = H100):
    """(bytes, operations, bound seconds, the peak the operations take) of
    one op."""
    def nbytes(name):
        v = graph.vars[name]
        b = _BYTES.get(v.precision, 4)
        if island_bf16 and v.precision == Precision.FP32 and not v.is_weight:
            b = 2
        return (int(np.prod(v.shape)) if v.shape else 1) * b

    bw, int8_peak, other_peak = _peaks(specs, island_bf16)
    traffic = sum(nbytes(n) for n in op.input_names())
    traffic += sum(nbytes(n) for n in op.output_names())
    flops = 0
    peak = other_peak
    if op.op_type in ("conv2d", "depthwise_conv2d", "conv2d_transpose",
                      "fused_dw_pw"):
        w = graph.vars[op.input("Filter")].shape
        o = graph.vars[op.output_names()[0]].shape
        flops = 2 * int(np.prod(o)) * w[0] * w[1] * w[2]
    elif op.op_type in ("fc", "mul"):
        wname = op.input("W" if op.op_type == "fc" else "Y")
        w = graph.vars[wname].shape
        o = graph.vars[op.output_names()[0]].shape
        flops = 2 * int(np.prod(o)) * int(np.prod(w[:-1]))
    elif op.op_type in ("matmul", "matmul_v2", "bmm"):
        x = graph.vars[op.input("X")].shape
        o = graph.vars[op.output_names()[0]].shape
        k = x[-1] if not op.attrs.get("transpose_X") else x[-2]
        flops = 2 * int(np.prod(o)) * int(k)
    if flops and op.attrs.get("enable_int8"):
        peak = int8_peak
    t = max(traffic / bw, flops / peak)
    return traffic, flops, t, peak


def roofline_report(graph: Graph, *, island_bf16: Optional[bool] = None,
                    profile: Optional[Dict[int, dict]] = None,
                    specs: Dict[str, float] = H100) -> dict:
    """The per-op and per-type roofline of `graph`; `profile` (op id →
    ``latency_report`` row) joins the measured ``ms``."""
    if island_bf16 is None:
        island_bf16 = graph.meta.get("island_dtype") == "bfloat16"
    bw = specs["hbm_gbps"] * 1e9
    per_op = []
    by_type: Dict[str, list] = {}
    total = 0.0
    for op in graph.topological_order():
        traffic, flops, t, peak = _op_cost(graph, op, island_bf16, specs)
        total += t
        meas = profile.get(op.id, {}).get("ms") if profile else None
        per_op.append({"id": op.id, "op": op.op_type,
                       "traffic_mb": round(traffic / 1e6, 2),
                       "gflops": round(flops / 1e9, 2),
                       "roof_us": round(t * 1e6, 2),
                       "bound": "compute" if flops and flops / peak > traffic / bw
                       else "memory",
                       **({"measured_ms": meas} if meas is not None else {})})
        agg = by_type.setdefault(op.op_type, [0.0, 0.0])
        agg[0] += t * 1e3
        agg[1] += (meas or 0.0)
    batch = graph.vars[graph.inputs[0]].shape[0] if graph.inputs else 1
    return {
        "roofline_total_ms": round(total * 1e3, 4),
        "roofline_items_per_sec": round(batch / total, 1),
        "by_op_type": {
            k: {"roof_ms": round(v[0], 4),
                **({"measured_ms": round(v[1], 4),
                    "x_off_roofline": round(v[1] / max(v[0], 1e-9), 2)}
                   if profile else {})}
            for k, v in sorted(by_type.items(), key=lambda kv: -kv[1][0])
        },
        "per_op": per_op,
    }


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--island-dtype", default="float32")
    p.add_argument("--profile", default=None,
                   help="tools/profile JSONL to join (measured ms per op id)")
    p.add_argument("--per-op", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the graph is calibrated; the peaks are this card's "
                        "(cpu: the H100's table entry)")
    args = p.parse_args()

    from .. import QuantConfig
    from ..core.device import resolve_device
    from .benchmark import resolve_builder
    from .opt import optimize
    from .profile import model_feed

    dev = resolve_device(args.device)
    specs = device_info.get(dev).specs if dev.type == "cuda" else H100
    builder = resolve_builder(args.model)
    if args.model == "ernie_tiny":
        g = builder(batch=args.batch, seq_len=args.seq_len)
    else:
        g = builder(batch=args.batch, image_size=args.image_size)
    if not args.fp32:
        optimize(g, quant=QuantConfig(island_dtype=args.island_dtype),
                 calib_batches=[model_feed(g)], device=dev)
    else:
        optimize(g, device=dev)
    prof = None
    if args.profile:
        with open(args.profile) as f:
            prof = {r["id"]: r for r in map(json.loads, f)}
    rep = roofline_report(g, profile=prof, specs=specs)
    if not args.per_op:
        rep.pop("per_op")
    print(json.dumps(rep, indent=1))


if __name__ == "__main__":
    main()
