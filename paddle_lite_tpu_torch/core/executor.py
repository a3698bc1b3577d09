"""Executor — runs an optimized Graph op by op, and compiles it into a CUDA
graph.

Port of ``paddle_lite_tpu/core/executor.py`` (``build_callable``,
``stage_weights``, ``compile_graph``), the analog of
``lite/core/program.{h,cc}`` (``RuntimeProgram::Run``'s instruction loop).
``build_callable`` is the eager loop: it runs on every call, in the same
topological order, with the same name-keyed ``env`` and the same
``capture(name, value)`` hook (called for every graph input and every op
output, ``executor.py:97-117`` there).  ``compile_graph`` is the port's
``jax.jit``: on the card it captures that loop once, on the first call, as
a ``torch.cuda.CUDAGraph`` over static input and output buffers, and every
later call replays it (:class:`CompiledGraph`).

bf16 islands (``graph.meta["island_dtype"] == "bfloat16"``, the
reference's rule at ``executor.py:86-136``): every float32 graph input and
every float32 op output is rounded to bf16 as it enters the name-keyed
env, so the next op reads bf16; int8, int32 and int64 values pass
untouched; float32 weights are staged as bf16 (int8 weights and the quant
scales, which live in the graph, are untouched); the graph's outputs are
returned as float32, the public contract.  The ops accumulate bf16
operands in float32 and promote as ``jnp`` does (``ops/common.upcast``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import InputStager, fp32_exact, to_tensor
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


ISLAND_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def island_dtype(graph: Graph) -> Optional[torch.dtype]:
    """The dtype float32 values are rounded to between ops: bf16 when
    ``graph.meta["island_dtype"]`` is ``"bfloat16"``, None for float32 (or
    no entry).  Any other entry raises."""
    name = graph.meta.get("island_dtype") or "float32"
    if name not in ISLAND_DTYPES:
        raise NotImplementedError(
            f"graph.meta['island_dtype'] = {name!r}: only 'float32' and "
            f"'bfloat16' islands are ported")
    return ISLAND_DTYPES[name]


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
    return _runner(graph, ExecutionContext(graph=graph, device=device), capture)


def _runner(graph: Graph, ctx: ExecutionContext,
            capture: Optional[Callable[[str, torch.Tensor], None]] = None):
    """The eager loop of `graph` over `ctx` (its device and per-op
    constants); impls are resolved here, so an unknown tag raises now."""
    order = graph.topological_order()
    impls = [OPS.get(op.op_type).impl_for(op.attrs.get("kernel"))
             for op in order]
    device = ctx.device
    island = island_dtype(graph)

    def to_island(a):
        if island is not None and a.dtype == torch.float32:
            return a.to(island)
        return a

    def run(weights: Dict[str, Any], inputs: Dict[str, Any]) -> Dict[str, Any]:
        env: Dict[str, Any] = dict(weights)
        with fp32_exact():
            for name in graph.inputs:
                x = to_tensor(inputs[name], device)
                want = graph.vars[name].precision.torch_dtype
                env[name] = to_island(x if x.dtype == want else x.to(want))
                if capture is not None:
                    capture(name, env[name])
            for op, impl in zip(order, impls):
                outs = impl(ctx, op, _resolve_inputs(op, env))
                for slot, arrs in outs.items():
                    for n, a in zip(op.outputs.get(slot, []), arrs):
                        env[n] = to_island(a)
                        if capture is not None:
                            capture(n, env[n])
            out = {n: env[n] for n in graph.outputs}
            if island is not None:  # the public contract stays float32
                out = {n: v.to(torch.float32) if v.dtype == island else v
                       for n, v in out.items()}
        return out

    return run


def stage_weights(graph: Graph, device: torch.device) -> Dict[str, torch.Tensor]:
    """Weights as device tensors, copied once.  Under bf16 islands float32
    weights are stored as bf16 (rounded to nearest even); int8 weights are
    untouched (``executor.py:122-136`` there)."""
    island = island_dtype(graph)
    out = {}
    for k, v in graph.weights.items():
        t = to_tensor(v, device)
        out[k] = t.to(island) if island is not None and t.dtype == torch.float32 else t
    return out


# one capture at a time in the process: a capture must not see another
# thread's capture begin or end, and the warm-up that precedes it fills
# per-op constants that clones share
_CAPTURE_LOCK = threading.Lock()


def host_syncing_ops(graph: Graph) -> List[str]:
    """"op_type (tag)" of every op of `graph` whose impl waits for the card
    on the host (registered with ``syncs_host=True``)."""
    return [f"{op.op_type} (kernel {op.attrs.get('kernel') or 'torch'!r}, "
            f"output {next(iter(op.outputs.values()))[0]})"
            for op in graph.topological_order()
            if OPS.get(op.op_type).syncs_host(op.attrs.get("kernel"))]


class CompiledGraph:
    """``fn(weights, inputs) -> outputs`` over static buffers: the
    ``jax.jit``-compiled function of the reference.

    On ``"cuda"`` the first call copies the inputs into the static input
    buffers, runs the eager loop once on them (the warm-up: it fills the
    per-op constants, folded scales and repacked weights, and loads and
    sets up the kernel libraries, none of which may happen inside a
    capture), then captures the loop as one ``torch.cuda.CUDAGraph`` with
    TF32 off; every call replays it.  A capture that fails raises; nothing
    falls back to the eager loop.  On ``"cpu"`` there is no CUDA graph: the
    same eager loop runs on the same static buffers, so the contract is the
    same on both devices:

    - inputs are cast to the input var's precision; an input of another
      shape raises;
    - the outputs are fresh tensors (one ``clone()`` a call), so a later
      call never changes a result already handed out;
    - ``weights`` must be the tensors the function was compiled with (the
      graph holds their pointers); any other dict raises.

    Calls on one instance are serialised; :meth:`clone` gives a function
    with its own buffers and graph that shares the weights and constants.
    """

    def __init__(self, graph: Graph, device: torch.device,
                 weights: Dict[str, torch.Tensor],
                 ctx: Optional[ExecutionContext] = None):
        syncing = host_syncing_ops(graph)
        if syncing:
            raise ValueError(
                f"compile_graph: {', '.join(syncing)} synchronise(s) with the "
                f"host and cannot be captured in a CUDA graph; tag it with a "
                f"kernel that does not, or run the eager build_callable")
        self.graph = graph
        self.device = device
        self.weights = weights
        self.ctx = ctx or ExecutionContext(graph=graph, device=device)
        self._run = _runner(graph, self.ctx)
        self._inputs = {
            n: torch.empty(graph.vars[n].shape,
                           dtype=graph.vars[n].precision.torch_dtype, device=device)
            for n in graph.inputs}
        self._outputs: Optional[Dict[str, torch.Tensor]] = None
        self._cuda_graph: Optional[torch.cuda.CUDAGraph] = None
        self._stager = InputStager() if device.type == "cuda" else None
        self._ptrs = {k: v.data_ptr() for k, v in weights.items()}
        self._lock = threading.RLock()

    @property
    def captured(self) -> bool:
        return self._cuda_graph is not None

    def clone(self) -> "CompiledGraph":
        """The same function with its own static buffers and its own graph
        (captured on its first call), sharing the weights and the per-op
        constants."""
        return CompiledGraph(self.graph, self.device, self.weights, self.ctx)

    def _check_weights(self, weights: Dict[str, Any]) -> None:
        if weights is self.weights:
            return
        if set(weights) != set(self._ptrs) or any(
                not isinstance(v, torch.Tensor) or v.data_ptr() != self._ptrs[k]
                for k, v in weights.items()):
            raise ValueError(
                "compiled graph: called with other weights than it was compiled "
                "with (the graph holds their device pointers); use the weights "
                "compile_graph returned")

    def _load(self, inputs: Dict[str, Any]) -> None:
        missing = [n for n in self._inputs if n not in inputs]
        if missing:
            raise ValueError(f"compiled graph: missing inputs {missing}")
        for name, dst in self._inputs.items():
            value = inputs[name]
            got = tuple(value.shape) if isinstance(value, torch.Tensor) \
                else tuple(np.shape(value))
            if got != tuple(dst.shape):
                raise ValueError(f"compiled graph: input {name!r} has shape {got}, "
                                 f"compiled for {tuple(dst.shape)}")
            if self._stager is None:
                dst.copy_(value if isinstance(value, torch.Tensor)
                          else torch.from_numpy(np.asarray(value)))
            else:
                self._stager.copy(name, value, dst)

    def warm_up(self, weights: Dict[str, Any], inputs: Dict[str, Any]) -> None:
        """Load `inputs` and run the eager loop once on the static buffers
        (the first call does this before it captures)."""
        self._check_weights(weights)
        with self._lock, _CAPTURE_LOCK:
            self._load(inputs)
            self._run(self.weights, self._inputs)

    def capture(self) -> None:
        """Capture the eager loop over the static buffers as a CUDA graph
        (after :meth:`warm_up`; the first call does both)."""
        with self._lock, _CAPTURE_LOCK, fp32_exact():
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = self._run(self.weights, self._inputs)
            self._outputs, self._cuda_graph = outputs, graph

    def __call__(self, weights: Dict[str, Any],
                 inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        self._check_weights(weights)
        with self._lock:
            if self.device.type == "cuda" and self._cuda_graph is None:
                self.warm_up(weights, inputs)
                self.capture()
            self._load(inputs)
            if self._cuda_graph is None:  # the CPU: the eager loop
                outputs = self._run(self.weights, self._inputs)
            else:
                self._cuda_graph.replay()
                outputs = self._outputs
            return {n: v.clone() for n, v in outputs.items()}


def compile_graph(graph: Graph, *, device: torch.device
                  ) -> Tuple[CompiledGraph, Dict[str, torch.Tensor]]:
    """Stage the weights and compile the graph: ``(fn, weights)``, as the
    reference returns ``(jax.jit(fn), weights)``; call ``fn(weights,
    inputs)``.  The ``GenRuntimeProgram`` + first-``Run`` analog.  Raises
    ``ValueError`` for a graph holding an impl that synchronises with the
    host (the ``"torch"`` NMS), naming the op."""
    weights = stage_weights(graph, device)
    return CompiledGraph(graph, device, weights), weights
