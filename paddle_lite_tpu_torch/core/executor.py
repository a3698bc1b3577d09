"""Executor — runs an optimized Graph op by op, eagerly.

Port of ``paddle_lite_tpu/core/executor.py`` (``build_callable``,
``stage_weights``), the analog of ``lite/core/program.{h,cc}``
(``RuntimeProgram::Run``'s instruction loop).  The JAX package traces the
loop once under ``jax.jit``; here the loop runs on every call, in the same
topological order, with the same name-keyed ``env`` and the same
``capture(name, value)`` hook (called for every graph input and every op
output, ``executor.py:97-117`` there).  The bf16 island
(``graph.meta["island_dtype"]``, ``executor.py:86-116``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import fp32_exact, to_tensor
from .ir import Graph, OpNode
from .registry import OPS


@dataclasses.dataclass
class ExecutionContext:
    """Per-callable context handed to every op impl: the graph (for quant
    metadata), the device, and per-op constants staged to the device once
    (effective scales, repacked weights)."""

    graph: Graph
    device: torch.device
    consts: Dict[Tuple[int, str], Any] = dataclasses.field(default_factory=dict)

    def var_quant(self, name: str):
        return self.graph.vars[name].quant

    def var_shape(self, name: str):
        return self.graph.vars[name].shape

    def const(self, op: OpNode, key: str, make: Callable[[], Any]) -> Any:
        """`make()` once per (op, key); later calls reuse the result (the
        ``PrepareForRun`` analog: scales folded and weights repacked once)."""
        k = (op.id, key)
        if k not in self.consts:
            self.consts[k] = make()
        return self.consts[k]

    def tensor(self, array) -> torch.Tensor:
        return to_tensor(np.asarray(array), self.device)


def _resolve_inputs(op: OpNode, env: Dict[str, Any]) -> Dict[str, List[Any]]:
    return {
        slot: [env[n] for n in names]
        for slot, names in op.inputs.items()
        if names
    }


def build_callable(
    graph: Graph,
    *,
    device: torch.device,
    capture: Optional[Callable[[str, torch.Tensor], None]] = None,
) -> Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Return ``fn(weights, inputs) -> outputs`` on name-keyed dicts.

    ``weights`` are device tensors (:func:`stage_weights`); ``inputs`` are
    numpy arrays or tensors, moved to ``device`` and cast to the input
    var's precision.  ``capture`` (if given) is
    called with every intermediate (name, value) — the hook used by the
    calibration runner and the cross-package tests.
    """
    if graph.meta.get("island_dtype"):
        raise NotImplementedError(
            "bf16 islands (graph.meta['island_dtype']) are not ported yet"
        )
    order = graph.topological_order()
    impls = [OPS.get(op.op_type).impl_for(op.attrs.get("kernel"))
             for op in order]
    ctx = ExecutionContext(graph=graph, device=device)

    def run(weights: Dict[str, Any], inputs: Dict[str, Any]) -> Dict[str, Any]:
        env: Dict[str, Any] = dict(weights)
        with fp32_exact():
            for name in graph.inputs:
                x = to_tensor(inputs[name], device)
                want = graph.vars[name].precision.torch_dtype
                env[name] = x if x.dtype == want else x.to(want)
                if capture is not None:
                    capture(name, env[name])
            for op, impl in zip(order, impls):
                outs = impl(ctx, op, _resolve_inputs(op, env))
                for slot, arrs in outs.items():
                    for n, a in zip(op.outputs.get(slot, []), arrs):
                        env[n] = a
                        if capture is not None:
                            capture(n, a)
        return {n: env[n] for n in graph.outputs}

    return run


def stage_weights(graph: Graph, device: torch.device) -> Dict[str, torch.Tensor]:
    """Weights as device tensors, copied once."""
    return {k: to_tensor(v, device) for k, v in graph.weights.items()}
