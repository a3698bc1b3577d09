"""Profilers — analog of ``lite/core/profile/``.

Port of the precision half of ``paddle_lite_tpu/tools/profile.py``
(``:29-111`` there): :func:`precision_report` ≈ ``precision_profiler.h``
runs the fp32 graph and the quantized graph on the same inputs, captures
every intermediate, and reports per-layer mean / std / absmax plus the
int8-vs-fp32 delta — layer-wise quantization-error hunting.  Both graphs run
through the eager loop (``core/executor.build_callable``, the only path
with the capture hook) on the given device, and the statistics are reduced
there, in float64, so only one small table comes back to the host.

Not ported yet (queue 1 item 6 of ``ROADMAP.md``): ``latency_report``
(per-op cost by prefix timing), its isotonic fit, and the module's
command line (``_main``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.executor import build_callable, stage_weights
from ..core.ir import Graph
from ..core.types import Precision


@dataclasses.dataclass
class LayerDelta:
    var: str
    op_type: str
    precision: str
    mean: float
    std: float
    absmax: float
    rel_err: float  # vs fp32 reference, max-normalized
    cos: float

    def row(self) -> str:
        return (f"{self.var:<32} {self.op_type:<18} {self.precision:<5} "
                f"mean={self.mean:+.4f} std={self.std:.4f} "
                f"absmax={self.absmax:.4f} rel={self.rel_err:.4f} "
                f"cos={self.cos:.5f}")


def _capture_all(graph: Graph, feed, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every graph input and op output of one eager run, on `device`."""
    caps: Dict[str, torch.Tensor] = {}
    run = build_callable(graph, device=device, capture=caps.__setitem__)
    run(stage_weights(graph, device), feed)
    return caps


def precision_report(
    fp32_graph: Graph,
    int8_graph: Graph,
    feed: Dict[str, np.ndarray],
    *,
    top: Optional[int] = None,
    device: DeviceLike = None,
) -> List[LayerDelta]:
    """Per-layer int8-vs-fp32 deltas; sorted worst-first when `top` given.

    An int8 value is dequantized by its scale in float32 (``x *
    float32(scale)``, as the reference does); the statistics are then
    taken in float64, where the reference takes them in float32."""
    dev = resolve_device(device)
    ref = _capture_all(fp32_graph, feed, dev)
    got = _capture_all(int8_graph, feed, dev)

    by_var_op = {}
    for op in int8_graph.ops:
        for n in op.output_names():
            by_var_op[n] = op.op_type

    names, rows = [], []
    for name, val in got.items():
        v = int8_graph.vars.get(name)
        if v is None or v.is_weight:
            continue
        x = val.to(torch.float32)
        if v.precision == Precision.INT8 and v.quant is not None:
            x = x * torch.tensor(np.float32(v.quant.scale[0]), device=dev)
        # compare against the fp32 var this one descends from (cast-inserted
        # vars are named <orig>.q8__k)
        r = ref.get(name.split(".q8__")[0])
        if r is None or r.shape != x.shape:
            continue
        x, r = x.double(), r.to(torch.float32).double()
        rel = (x - r).abs().max() / (r.abs().max() + 1e-9)
        cos = (x * r).sum() / (x.norm() * r.norm() + 1e-12)
        rows.append(torch.stack([x.mean(), x.std(unbiased=False), x.abs().max(),
                                 rel, cos]))
        names.append(name)
    table = torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 5))
    out = [LayerDelta(var=name, op_type=by_var_op.get(name, "input"),
                      precision=int8_graph.vars[name].precision.value,
                      mean=float(m), std=float(s), absmax=float(a),
                      rel_err=float(re), cos=float(c))
           for name, (m, s, a, re, c) in zip(names, table)]
    if top:
        out.sort(key=lambda d: d.cos)
        out = out[:top]
    return out


def print_precision_report(fp32_graph, int8_graph, feed, top=None,
                           device: DeviceLike = None) -> None:
    rows = precision_report(fp32_graph, int8_graph, feed, top=top, device=device)
    print(f"{'var':<32} {'op':<18} prec  stats")
    for r in rows:
        print(r.row())
