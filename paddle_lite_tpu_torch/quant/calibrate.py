"""PTQ calibration runner.

Port of ``paddle_lite_tpu/quant/calibrate.py``: run the fp32 graph over the
calibration batches with a ``capture`` hook and reduce every watched tensor
to its abs-max on the device; only one small vector per batch comes back to
the host.  The JAX package jits a "stats program"; here the eager executor
runs the graph (``core/executor.build_callable``).  The histogram methods
(percentile, KL) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..core.executor import build_callable, stage_weights
from ..core.ir import Graph
from ..core.types import CalibMethod
from .observers import Observer, make_observer

# ops whose int8 kernels need calibrated input/output activation scales
QUANTIZABLE_OPS = ("conv2d", "depthwise_conv2d", "fc", "mul", "matmul")
# shape-preserving ops an int8 tensor flows through unchanged (same scale)
TRANSPARENT_OPS = (
    "reshape", "reshape2", "flatten", "flatten2", "squeeze", "squeeze2",
    "unsqueeze", "unsqueeze2", "transpose", "transpose2",
    "split",  # slices share the input's scale (QKV-fused GEMM outputs)
)
# pool2d is int8-in/int8-out with the same scale (max exactly; avg rounds);
# nearest_interp copies values exactly
PASSTHROUGH_OPS = TRANSPARENT_OPS + ("pool2d", "nearest_interp",
                                     "nearest_interp_v2")


def vars_needing_scales(graph: Graph) -> List[str]:
    """Activation vars adjacent to quantizable ops (inputs AND outputs —
    outputs need scales for the fused requant epilogue), plus vars feeding
    transparent/pool chains into them."""
    names: set = set()
    for op in graph.ops:
        if op.op_type in QUANTIZABLE_OPS:
            for slot in ("Input", "X", "Y", "W"):
                for n in op.inputs.get(slot, []):
                    if not graph.vars[n].is_weight:
                        names.add(n)
            for n in op.output_names():
                names.add(n)
        if op.op_type in PASSTHROUGH_OPS:
            for n in op.input_names() + op.output_names():
                if not graph.vars[n].is_weight:
                    names.add(n)
    return sorted(names)


@dataclasses.dataclass
class CalibrationResult:
    scales: Dict[str, float]  # var name -> per-tensor activation scale

    def scale(self, name: str) -> float:
        return self.scales[name]


def calibrate(
    graph: Graph,
    batches: Iterable[Dict[str, np.ndarray]],
    method: CalibMethod = CalibMethod.ABS_MAX,
    *,
    device: torch.device,
    observer_kwargs: Optional[dict] = None,
) -> CalibrationResult:
    """Run calibration batches through the fp32 graph on `device`; return
    per-tensor activation scales for every var adjacent to a quantizable
    op."""
    batches = list(batches)
    if not batches:
        raise ValueError("calibration requires at least one batch")
    watch = vars_needing_scales(graph)
    observers: Dict[str, Observer] = {
        n: make_observer(method, **(observer_kwargs or {})) for n in watch
    }
    if any(o.needs_histogram for o in observers.values()):
        raise NotImplementedError(
            f"calibration method {method} (histogram) is not ported yet")
    watch_set = set(watch)
    stats: Dict[str, torch.Tensor] = {}

    def capture(name: str, val: torch.Tensor) -> None:
        if name in watch_set:
            stats[name] = val.abs().amax().to(torch.float32)

    run = build_callable(graph, device=device, capture=capture)
    weights = stage_weights(graph, device)
    for batch in batches:
        stats.clear()
        run(weights, batch)
        names = list(stats)
        amax = torch.stack([stats[n] for n in names]).cpu().numpy()
        for n, a in zip(names, amax):
            observers[n].update_absmax(float(a))
    return CalibrationResult(
        scales={n: obs.scale() for n, obs in observers.items()})
