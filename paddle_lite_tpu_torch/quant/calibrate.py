"""PTQ calibration runner.

Port of ``paddle_lite_tpu/quant/calibrate.py``: run the fp32 graph over the
calibration batches with a ``capture`` hook and reduce every watched tensor
on the device, so only small per-batch vectors come back to the host.  The
JAX package jits a "stats program"; here the eager executor runs the graph
(``core/executor.build_callable``).

- The first pass takes each watched tensor's abs-max and, for bias
  correction, its per-channel means (last axis; the mean of the per-batch
  means, as the reference, ``calibrate.py:134-146`` there).
- For the histogram methods (percentile, KL) a second pass counts ``|x|``
  in ``bins`` bins over ``[0, max(amax, 1e-10)]``: the edges are
  ``jnp.linspace``'s as XLA computes them, bit for bit
  (:func:`hist_edges`, made on the host; tested against ``jnp.linspace``),
  and a value goes where ``jnp.histogram`` puts it (``searchsorted`` right,
  a value equal to the last edge in the last bin), not where
  ``torch.histc`` would.  The counts are exact integers; the reference's
  are float32, which stop counting past 2^24 in a bin.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..core import trace
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


def hist_edges(amax: float, bins: int) -> np.ndarray:
    """``jnp.linspace(0.0, max(amax, 1e-10), bins + 1)`` in float32, bit
    for bit, as XLA computes it on the CPU (JAX 0.9, ``_linspace``): its
    ``start * (1 - step) + stop * step`` with ``step = iota / bins`` comes
    out as ``(stop * r) * iota``, ``r`` the float32 reciprocal of ``bins``
    (XLA turns the division by a constant into a product by its reciprocal
    and folds the constants together); the stop itself is the last
    edge."""
    stop = np.float32(max(amax, 1e-10))
    r = np.float32(1.0) / np.float32(bins)
    edges = (stop * r) * np.arange(bins, dtype=np.float32)
    return np.append(edges, stop).astype(np.float32)


def hist_counts(values: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``jnp.histogram(values, bins=edges)``'s counts as int64: each value
    in ``searchsorted(edges, v, side="right") - 1``, one equal to the last
    edge in the last bin, one past it in none."""
    bins = edges.numel() - 1
    idx = torch.searchsorted(edges, values, right=True)
    idx = torch.where(values == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 2)[1:bins + 1]


@dataclasses.dataclass
class CalibrationResult:
    scales: Dict[str, float]  # var name -> per-tensor activation scale
    channel_means: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)  # var name -> E[x] per channel (bias corr.)

    def scale(self, name: str) -> float:
        return self.scales[name]


def _make_observers(watch, method, bins, observer_kwargs) -> Dict[str, Observer]:
    """One observer a watched tensor.  The histogram observers get
    `bins`: the reference's keep their default 2048 whatever `bins` is, and
    fail at the first histogram of another size."""
    kw = dict(observer_kwargs or {})
    if method in (CalibMethod.PERCENTILE, CalibMethod.ENTROPY):
        if kw.setdefault("bins", bins) != bins:
            raise ValueError(f"observer_kwargs bins={kw['bins']} != bins={bins}")
    return {n: make_observer(method, **kw) for n in watch}


@trace.setup_span("setup.calibrate")
def calibrate(
    graph: Graph,
    batches: Iterable[Dict[str, np.ndarray]],
    method: CalibMethod = CalibMethod.ABS_MAX,
    *,
    device: torch.device,
    bins: int = 2048,
    observer_kwargs: Optional[dict] = None,
    collect_channel_means: bool = False,
) -> CalibrationResult:
    """Run calibration batches through the fp32 graph on `device`; return
    per-tensor activation scales for every var adjacent to a quantizable
    op (and, with `collect_channel_means`, each one's E[x] per channel)."""
    batches = list(batches)
    if not batches:
        raise ValueError("calibration requires at least one batch")
    watch = vars_needing_scales(graph)
    watch_set = set(watch)
    observers = _make_observers(watch, method, bins, observer_kwargs)
    weights = stage_weights(graph, device)
    stats: Dict[str, torch.Tensor] = {}
    means: Dict[str, torch.Tensor] = {}

    def first_pass(name: str, val: torch.Tensor) -> None:
        if name in watch_set:
            v = val.to(torch.float32)
            stats[name] = v.abs().amax()
            if collect_channel_means:  # E[x] along the channel (last) axis
                means[name] = v.reshape(-1, v.shape[-1]).mean(dim=0)

    run = build_callable(graph, device=device, capture=first_pass)
    mean_acc: Dict[str, np.ndarray] = {}
    for batch in batches:
        stats.clear()
        means.clear()
        run(weights, batch)
        names, mnames = list(stats), list(means)
        # one copy to the host a batch: the abs-maxes, then the means
        flat = torch.cat([torch.stack([stats[n] for n in names])]
                         + [means[n] for n in mnames]).cpu().numpy()
        for n, a in zip(names, flat):
            observers[n].update_absmax(float(a))
        off = len(names)
        for n in mnames:
            c = means[n].numel()
            m = flat[off:off + c]
            mean_acc[n] = m if n not in mean_acc else mean_acc[n] + m
            off += c
    channel_means = {n: v / len(batches) for n, v in mean_acc.items()}

    if watch and observers[watch[0]].needs_histogram:
        amax = {n: obs.amax for n, obs in observers.items()}
        edges = {n: torch.from_numpy(hist_edges(a, bins)).to(device)
                 for n, a in amax.items()}
        counts: Dict[str, torch.Tensor] = {}

        def second_pass(name: str, val: torch.Tensor) -> None:
            if name in watch_set:
                counts[name] = hist_counts(val.to(torch.float32).abs().reshape(-1),
                                           edges[name])

        run = build_callable(graph, device=device, capture=second_pass)
        for batch in batches:
            counts.clear()
            run(weights, batch)
            names = list(counts)
            hists = torch.stack([counts[n] for n in names]).cpu().numpy()
            for n, h in zip(names, hists):
                observers[n].update_histogram(h, amax[n])

    return CalibrationResult(
        scales={n: obs.scale() for n, obs in observers.items()},
        channel_means=channel_means)
