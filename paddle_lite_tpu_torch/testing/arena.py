"""Arena — the op-level test harness (``lite/core/arena/framework.{h,cc}``).

Port of ``paddle_lite_tpu/testing/arena.py``: an :class:`OpTestCase`
supplies an op's inputs, attrs and output slots; :func:`run_arena` runs the
op under every registered kernel tag (``"torch"``, ``"cuda"``) as a one-op
graph through the eager executor and holds each to a baseline within the
case's tolerance.  Two additions: a case states each output's precision
and the per-tensor scales of its int8 vars, and :func:`run_case` /
:func:`compare` run one case on a device and hold two runs to each other
(the card against the CPU).  ``testing/op_cases.py`` holds a case for
every registered op name.

Var names follow the cross-package tests' one-op harness: input ``i`` of
slot ``S`` is ``"s{i}"`` (the slot lower-cased), the k-th output of the op
``"out_s{k}"``.  An input is a graph input unless its slot is among the
case's ``weight_slots``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.executor import build_callable, stage_weights
from ..core.ir import Graph
from ..core.registry import OPS
from ..core.types import Precision, QuantInfo

PRECISIONS = {np.dtype(np.float32): "FP32", np.dtype(np.int32): "INT32",
              np.dtype(np.int64): "INT64", np.dtype(np.bool_): "BOOL",
              np.dtype(np.int8): "INT8"}


@dataclasses.dataclass
class OpTestCase:
    """One op on seeded inputs.  ``outs`` lists (slot, precision name) per
    output the shape function gives; ``scales`` the per-tensor scale of an
    int8 var by name (inputs and outputs).  ``exact``: every output is
    compared bit for bit; otherwise float outputs within ``rtol`` /
    ``atol`` (against the reference) or ``card_rtol`` / ``card_atol`` (the
    card against the CPU), integer and boolean ones still exactly."""

    op_type: str
    inputs: Dict[str, List[np.ndarray]]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    outs: Sequence[Tuple[str, str]] = (("Out", "FP32"),)
    scales: Dict[str, float] = dataclasses.field(default_factory=dict)
    exact: bool = True
    rtol: float = 1e-5
    atol: float = 1e-6
    card_rtol: float = 1e-5
    card_atol: float = 1e-5
    weight_slots: Sequence[str] = ()  # slots staged as graph weights

    def feed(self) -> Dict[str, np.ndarray]:
        return {f"{s.lower()}{i}": a for s, arrs in self.inputs.items()
                if s not in self.weight_slots for i, a in enumerate(arrs)}


def build_graph(case: OpTestCase) -> Graph:
    """The one-op graph of `case`."""
    g = Graph(f"arena_{case.op_type}")
    names: Dict[str, List[str]] = {}
    for slot, arrs in case.inputs.items():
        names[slot] = []
        for i, a in enumerate(arrs):
            n = f"{slot.lower()}{i}"
            if slot in case.weight_slots:
                v = g.add_weight(n, np.asarray(a))
            else:
                v = g.add_var(n, a.shape, precision=Precision[PRECISIONS[np.asarray(a).dtype]])
                g.inputs.append(n)
            if n in case.scales:
                v.quant = QuantInfo.per_tensor(case.scales[n])
            names[slot].append(n)
    shapes = OPS.get(case.op_type).infer_shape(
        case.attrs, [np.shape(a) for arrs in case.inputs.values() for a in arrs])
    if len(shapes) != len(case.outs):
        raise ValueError(f"{case.op_type}: the shape function gives {len(shapes)} "
                         f"outputs, the case lists {len(case.outs)}")
    out_names: Dict[str, List[str]] = {}
    for k, ((slot, prec), shape) in enumerate(zip(case.outs, shapes)):
        n = f"out_{slot.lower()}{k}"
        v = g.add_var(n, shape, precision=Precision[prec])
        if n in case.scales:
            v.quant = QuantInfo.per_tensor(case.scales[n])
        out_names.setdefault(slot, []).append(n)
        g.outputs.append(n)
    g.add_op(case.op_type, names, out_names, dict(case.attrs))
    g.rebuild_links()
    return g


def run_case(case: OpTestCase, device: torch.device,
             kernel: Optional[str] = None) -> List[torch.Tensor]:
    """`case` on `device` under `kernel` (the op's default if None): its
    outputs in the graph's order."""
    g = build_graph(case)
    if kernel is not None:
        g.ops[0].attrs["kernel"] = kernel
    out = build_callable(g, device=device)(stage_weights(g, device), case.feed())
    return [out[n] for n in g.outputs]


def compare(got: Sequence[Any], want: Sequence[Any], case: OpTestCase,
            card: bool = False) -> Optional[str]:
    """None if `got` matches `want` under the case's rule, else why not.
    Integer and boolean outputs must be equal; float outputs too where the
    case is exact, else within its tolerance (``card_*`` with `card`)."""
    rtol, atol = (case.card_rtol, case.card_atol) if card else (case.rtol, case.atol)
    if len(got) != len(want):
        return f"{len(got)} outputs, expected {len(want)}"
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        if g.shape != w.shape or g.dtype != w.dtype:
            return f"output {k}: {g.shape} {g.dtype}, expected {w.shape} {w.dtype}"
        if case.exact or g.dtype.kind not in "fc":
            if not np.array_equal(g, w, equal_nan=g.dtype.kind in "fc"):
                return f"output {k}: {int((g != w).sum())} elements differ"
        elif not np.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True):
            err = np.nanmax(np.abs(g.astype(np.float64) - w))
            return f"output {k}: max abs diff {err:.3g} (rtol {rtol}, atol {atol})"
    return None


def run_arena(case: OpTestCase,
              baseline: Callable[[Dict[str, List[np.ndarray]]], Sequence[np.ndarray]],
              kernels: Optional[Sequence[str]] = None,
              device: Optional[torch.device] = None) -> Dict[str, List[torch.Tensor]]:
    """Run the op under every registered kernel tag (or `kernels`) and hold
    each to ``baseline(case.inputs)`` (its outputs in the graph's order);
    return the outputs by tag.  Raises AssertionError on a mismatch."""
    device = device or torch.device("cpu")
    kernels = list(kernels or sorted(OPS.get(case.op_type).impls))
    want = baseline(case.inputs)
    results = {}
    for kernel in kernels:
        got = run_case(case, device, kernel)
        err = compare(got, want, case)
        assert err is None, f"{case.op_type} kernel={kernel}: {err}"
        results[kernel] = got
    return results
