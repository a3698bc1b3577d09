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
later call replays it (:class:`CompiledGraph`); a graph with ``while`` /
``conditional_block`` ops is captured as one CUDA graph a segment between
them, the control flow run on the host, each block compiled the same way.
The execution context may name more such cuts: ops after which a step
runs on the host between two replays (:meth:`ExecutionContext.host_step`:
a sharded run's collectives).

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

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .device import InputStager, fp32_exact, to_tensor
from .ir import Graph, OpNode
from .registry import OPS


@dataclasses.dataclass
class ExecutionContext:
    """Per-callable context handed to every op impl: the graph (for quant
    metadata), the device, and per-op constants staged to the device once
    (effective scales, repacked weights).  A multi-process run's context
    (``parallel.sharding.ShardedContext``) holds its mesh and answers
    :meth:`var_quant` / :meth:`var_shape` with the rank's slice of a
    sharded var, :meth:`impl_for` with the impl an op runs on its shard
    and :meth:`host_step` with the collective that follows it."""

    graph: Graph
    device: torch.device
    consts: Dict[Tuple[int, str], Any] = dataclasses.field(default_factory=dict)

    def var_quant(self, name: str):
        return self.graph.vars[name].quant

    def var_shape(self, name: str):
        return self.graph.vars[name].shape

    def impl_for(self, op: OpNode):
        """The impl `op` runs: its registered impl for its kernel tag."""
        return OPS.get(op.op_type).impl_for(op.attrs.get("kernel"))

    def host_step(self, op: OpNode) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
        """The step run on each output of `op` before any other op reads
        it, outside a captured segment (the compiled path cuts the graph
        after `op`), or None: here always None, so a single-device graph
        is cut only at its control flow."""
        return None

    def const(self, op: OpNode, key: str, make: Callable[[], Any]) -> Any:
        """`make()` once per (op, key); later calls reuse the result (the
        ``PrepareForRun`` analog: scales folded and weights repacked once).
        Inside a block that Dynamo traces for an exported ``while_loop`` /
        ``cond``, which allows no side effect, `make()` is traced into the
        block instead of stored."""
        k = (op.id, key)
        if k not in self.consts:
            if torch.compiler.is_dynamo_compiling():
                return make()
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
    context: Optional[ExecutionContext] = None,
) -> Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Return ``fn(weights, inputs) -> outputs`` on name-keyed dicts.

    ``weights`` are device tensors (:func:`stage_weights`); ``inputs`` are
    numpy arrays or tensors, moved to ``device`` and cast to the input
    var's precision.  ``capture`` (if given) is
    called with every intermediate (name, value) — the hook used by the
    calibration runner and the cross-package tests.  ``context`` is the
    :class:`ExecutionContext` to run in (a sharded run's), else a fresh
    one on ``device``.
    """
    ctx = context if context is not None else ExecutionContext(graph=graph, device=device)
    return _runner(graph, ctx, capture)


def _op_runner(graph: Graph, ops: List[OpNode], ctx: ExecutionContext,
               capture: Optional[Callable[[str, torch.Tensor], None]] = None,
               host_steps: bool = True):
    """``run(env)``: `ops` in order over the name-keyed `env`, each output
    written into it (rounded to the island dtype, then through the
    context's host step where it names one and `host_steps` is set: the
    eager loop; a compiled segment runs the steps between replays).
    Impls are resolved here, so an unknown tag raises now."""
    impls = [ctx.impl_for(op) for op in ops]
    steps = [ctx.host_step(op) if host_steps else None for op in ops]
    island = island_dtype(graph)

    def run(env: Dict[str, Any]) -> None:
        for op, impl, step in zip(run.ops, impls, steps):
            outs = impl(ctx, op, _resolve_inputs(op, env))
            for slot, arrs in outs.items():
                for n, a in zip(op.outputs.get(slot, []), arrs):
                    a = _to_island(a, island)
                    env[n] = a if step is None else step(a)
                    if capture is not None:
                        capture(n, env[n])

    run.ops = ops
    return run


def _to_island(a, island: Optional[torch.dtype]):
    if island is not None and a.dtype == torch.float32:
        return a.to(island)
    return a


def _load_env(graph: Graph, weights: Dict[str, Any], inputs: Dict[str, Any],
              device: torch.device, capture=None) -> Dict[str, Any]:
    """The env a run starts from: the weights and the graph inputs, moved
    to `device`, cast to the input var's precision and rounded to the
    island dtype."""
    island = island_dtype(graph)
    env: Dict[str, Any] = dict(weights)
    for name in graph.inputs:
        x = to_tensor(inputs[name], device)
        want = graph.vars[name].precision.torch_dtype
        env[name] = _to_island(x if x.dtype == want else x.to(want), island)
        if capture is not None:
            capture(name, env[name])
    return env


def _public_outputs(graph: Graph, env: Dict[str, Any]) -> Dict[str, Any]:
    """The graph's outputs; under islands float32, the public contract."""
    island = island_dtype(graph)
    out = {n: env[n] for n in graph.outputs}
    if island is not None:
        out = {n: v.to(torch.float32) if v.dtype == island else v
               for n, v in out.items()}
    return out


def _runner(graph: Graph, ctx: ExecutionContext,
            capture: Optional[Callable[[str, torch.Tensor], None]] = None,
            exact: bool = True):
    """The eager loop of `graph` over `ctx` (its device and per-op
    constants), with TF32 off (:func:`fp32_exact`) unless `exact` is
    False: a block traced inside an exported program, whose caller sets
    it (Dynamo traces no context manager)."""
    ops = _op_runner(graph, graph.topological_order(), ctx, capture)

    def run(weights: Dict[str, Any], inputs: Dict[str, Any]) -> Dict[str, Any]:
        env = _load_env(graph, weights, inputs, ctx.device, capture)
        ops(env)
        return _public_outputs(graph, env)

    if not exact:
        return run

    def run_exact(weights: Dict[str, Any], inputs: Dict[str, Any]) -> Dict[str, Any]:
        with fp32_exact():
            return run(weights, inputs)

    return run_exact


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
# per-op constants that clones share.  Reentrant: capturing a graph with
# control flow compiles each block (warm-up and capture) between the
# outer segments' captures, on the same thread
_CAPTURE_LOCK = threading.RLock()


@contextlib.contextmanager
def capture_session() -> Iterator[None]:
    """Around captures of several CUDA graphs made by hand
    (``CUDAGraph.capture_begin`` / ``capture_end``, one memory pool): the
    process's capture lock held, the card synchronised, and a side stream
    current, as ``torch.cuda.graph`` sets them for one graph."""
    with _CAPTURE_LOCK:
        torch.cuda.synchronize()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            yield
        torch.cuda.current_stream().wait_stream(stream)


def capture_cuda_graph(fn: Callable[[], Any], *, warm_up: bool = False
                       ) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """``fn()`` captured as one ``torch.cuda.CUDAGraph`` under the
    process's capture lock, after one eager call of it where `warm_up` is
    set (the kernel libraries load and set up, which no capture may do).
    Returns the graph and what the captured ``fn()`` returned: tensors
    that every replay rewrites.  A capture that fails raises."""
    with _CAPTURE_LOCK:
        if warm_up:
            fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
    return graph, out


# ops the compiled path runs on the host between captured segments: each
# reads a condition back, and its block is compiled into graphs of its own
CONTROL_FLOW = ("while", "conditional_block")


def nested_graphs(op: OpNode) -> List[Graph]:
    """The graphs an op carries in its attrs (control-flow blocks, a
    subgraph's region)."""
    return [v for v in op.attrs.values() if isinstance(v, Graph)]


def host_syncing_ops(graph: Graph, cut: bool = True) -> List[str]:
    """"op_type (tag)" of every op of `graph`, or of a graph nested in it,
    whose impl waits for the card on the host (registered with
    ``syncs_host=True``), less the control-flow ops (:data:`CONTROL_FLOW`)
    of a graph that the compiled path cuts into segments (`cut`): the top
    level and the control-flow blocks.  A ``subgraph``'s region stays
    inline in its segment's capture, so control flow there counts."""
    found = []
    for op in graph.topological_order():
        flow = cut and op.op_type in CONTROL_FLOW
        if not flow and OPS.get(op.op_type).syncs_host(op.attrs.get("kernel")):
            found.append(f"{op.op_type} (kernel {op.attrs.get('kernel') or 'torch'!r}, "
                         f"output {next(iter(op.outputs.values()))[0]})")
        for g in nested_graphs(op):
            found += host_syncing_ops(g, cut=flow)
    return found


def refuse_host_syncing(graph: Graph) -> None:
    """Raise ``ValueError`` naming every op of :func:`host_syncing_ops`:
    no CUDA graph (and no exported program) can hold it."""
    syncing = host_syncing_ops(graph)
    if syncing:
        raise ValueError(
            f"compile_graph: {', '.join(syncing)} synchronise(s) with the "
            f"host and cannot be captured in a CUDA graph; tag it with a "
            f"kernel that does not, or run the eager build_callable")


def _plan(graph: Graph, ctx: ExecutionContext) -> list:
    """The topological order cut at the control-flow ops and after each op
    for which `ctx` names a host step: lists of ops (a segment, one CUDA
    graph each), control-flow ops and :class:`_HostStep`s, in order; the
    first step is a segment, maybe empty."""
    steps: list = [[]]
    for op in graph.topological_order():
        if op.op_type in CONTROL_FLOW:
            steps.append(op)
            continue
        if not isinstance(steps[-1], list):
            steps.append([])
        steps[-1].append(op)
        fn = ctx.host_step(op)
        if fn is not None:
            steps.append(_HostStep(op, fn))
    return steps


class _HostStep:
    """A context's host step after `op` in the compiled path (a sharded
    run's gather): `fn` on each of the op's outputs, run on the host
    between two segments.  It reads the output from the tensor the
    previous segment wrote, and copies its result into a static buffer of
    its own (made at the first run, outside any capture), which the next
    segment reads: a captured graph reads fixed addresses, so the fresh
    tensor `fn` returns is never handed on."""

    def __init__(self, op: OpNode, fn: Callable[[torch.Tensor], torch.Tensor]):
        self.op = op
        self.fn = fn
        self.names = op.output_names()
        self.src: Dict[str, torch.Tensor] = {}
        self.dst: Dict[str, torch.Tensor] = {}

    def __call__(self, env: Dict[str, Any]) -> None:
        """Run on `env`'s outputs of the op (an eager run over the static
        buffers, or the capture, whose tensors later replays rewrite), and
        put the static buffers in their place."""
        self.src = {n: env[n] for n in self.names}
        self.replay()
        env.update(self.dst)

    def replay(self) -> None:
        """Run again on the tensors of the last :meth:`__call__`."""
        for n, t in self.src.items():
            out = self.fn(t)
            if n not in self.dst:
                self.dst[n] = torch.empty_like(out)
            self.dst[n].copy_(out)


def load_static_inputs(what: str, inputs: Dict[str, Any], buffers: Dict[str, torch.Tensor],
                       stager: Optional[InputStager]) -> None:
    """Copy `inputs` (numpy arrays or tensors) into the static input
    `buffers` of a compiled function (`what`, for the messages), cast to
    each buffer's dtype, through `stager` on the card; a missing input or
    one of another shape raises ``ValueError``."""
    missing = [n for n in buffers if n not in inputs]
    if missing:
        raise ValueError(f"{what}: missing inputs {missing}")
    for name, dst in buffers.items():
        value = inputs[name]
        got = tuple(value.shape) if isinstance(value, torch.Tensor) \
            else tuple(np.shape(value))
        if got != tuple(dst.shape):
            raise ValueError(f"{what}: input {name!r} has shape {got}, "
                             f"compiled for {tuple(dst.shape)}")
        if stager is None:
            dst.copy_(value if isinstance(value, torch.Tensor)
                      else torch.from_numpy(np.asarray(value)))
        else:
            stager.copy(name, value, dst)


def _shares_storage(t: torch.Tensor, others) -> bool:
    p = t.untyped_storage().data_ptr()
    return any(o.untyped_storage().data_ptr() == p for o in others)


class _While:
    """A ``while`` op in the compiled path: its block compiled once
    (:class:`CompiledGraph`, its own graphs), its static input buffers the
    loop state.  A call copies the state in, then replays the block once a
    trip and copies its outputs back into the state, while the condition,
    read on the host, holds and fewer than ``max_iters`` trips ran (the
    reference's contract, ``ops/control_flow.while``).  A state var that
    the block passes through under its own name (a carried weight) is its
    input buffer itself, neither copied out nor back.  The final state
    buffers are the op's outputs."""

    def __init__(self, op: OpNode, device: torch.device):
        block = op.attrs["block"]
        if len(block.outputs) != len(block.inputs):
            raise ValueError("while block must output one var per state input")
        self.names = list(block.inputs)
        self.outs = list(block.outputs)
        self.body = CompiledGraph(block, device, stage_weights(block, device),
                                  carried={n for n, o in zip(self.names, self.outs)
                                           if n == o})
        self.cond = self.names[int(op.attrs.get("cond_index", 0))]
        self.max_iters = int(op.attrs.get("max_iters", 1000))
        self.trips = 0  # of the last call

    def __call__(self, ins: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
        state = self.body._inputs
        for n, x in zip(self.names, ins["X"]):
            state[n].copy_(x)
        trips = 0
        while trips < self.max_iters and bool(state[self.cond].reshape(-1)[0]):
            out = self.body.run_static()
            for n, o in zip(self.names, self.outs):
                if out[o] is not state[n]:
                    state[n].copy_(out[o])
            trips += 1
        self.trips = trips
        return {"Out": [state[n] for n in self.names]}

    @property
    def n_graphs(self) -> int:
        return self.body.n_graphs


class _ConditionalBlock:
    """A ``conditional_block`` op in the compiled path: its block compiled
    once; a call reads ``Cond`` on the host and either runs the block on
    the inputs or passes them through, into static output buffers."""

    def __init__(self, op: OpNode, device: torch.device):
        block = op.attrs["block"]
        self.body = CompiledGraph(block, device, stage_weights(block, device))
        self.names = list(block.inputs)
        self.outs = list(block.outputs)
        self.buffers: Optional[List[torch.Tensor]] = None

    def __call__(self, ins: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
        xs = ins["Input"]
        if self.buffers is None:
            self.buffers = [torch.empty_like(x) for x in xs]
        if bool(ins["Cond"][0].reshape(-1)[0]):
            for n, x in zip(self.names, xs):
                self.body._inputs[n].copy_(x)
            out = self.body.run_static()
            for buf, o in zip(self.buffers, self.outs):
                buf.copy_(out[o])
        else:
            for buf, x in zip(self.buffers, xs):
                buf.copy_(x)
        return {"Out": list(self.buffers)}

    @property
    def n_graphs(self) -> int:
        return self.body.n_graphs


_CONTROL_EXEC = {"while": _While, "conditional_block": _ConditionalBlock}


class CompiledGraph:
    """``fn(weights, inputs) -> outputs`` over static buffers: the
    ``jax.jit``-compiled function of the reference.

    The graph is cut at its control-flow ops (``while``,
    ``conditional_block``) into segments.  On ``"cuda"`` the first call
    copies the inputs into the static input buffers, runs the segments
    eagerly once on them (the warm-up: it fills the per-op constants, folded
    scales and repacked weights, and loads and sets up the kernel libraries,
    none of which may happen inside a capture), then captures each segment as a
    ``torch.cuda.CUDAGraph`` with TF32 off; every call replays them.  A
    control-flow op runs on the host between two segments: its block is
    compiled by this class into graphs of its own, once, and replayed once
    a trip on static state buffers; the condition is read on the host
    (:class:`_While`, :class:`_ConditionalBlock`).  The graph is also cut
    after each op for which the context names a host step
    (:meth:`ExecutionContext.host_step`, a sharded run's collective): the
    step runs on the host between the two replays, from the tensor the
    first segment wrote into a static buffer the second reads
    (:class:`_HostStep`).  A graph without either is one segment, one CUDA
    graph.  ``subgraph`` stays inline in its segment.  The static input
    buffers have the context's shapes (:meth:`ExecutionContext.var_shape`:
    a rank's data shard).  A capture that fails raises; nothing falls back
    to the eager loop.  :attr:`n_graphs` counts the CUDA graphs captured, nested ones
    included.  On ``"cpu"`` there is no CUDA graph: the segments run
    eagerly, and the control-flow ops through their compiled blocks, on
    the same static buffers, so the contract is the same on both devices:

    - inputs are cast to the input var's precision; an input of another
      shape raises;
    - the outputs are fresh tensors (one ``clone()`` a call), so a later
      call never changes a result already handed out;
    - ``weights`` must be the tensors the function was compiled with (the
      graph holds their pointers); any other dict raises.

    Calls on one instance are serialised; :meth:`clone` gives a function
    with its own buffers and graphs that shares the weights and constants.
    `carried` names inputs that the graph outputs unchanged under the same
    name (a ``while`` block's carried state): such an output is the static
    input buffer itself, not a copy of it.
    """

    def __init__(self, graph: Graph, device: torch.device,
                 weights: Dict[str, torch.Tensor],
                 ctx: Optional[ExecutionContext] = None, carried=frozenset()):
        refuse_host_syncing(graph)
        self.graph = graph
        self.device = device
        self.weights = weights
        self.ctx = ctx or ExecutionContext(graph=graph, device=device)
        self.carried = frozenset(carried)
        self._steps = [_op_runner(graph, s, self.ctx, host_steps=False)
                       if isinstance(s, list) else s if isinstance(s, _HostStep)
                       else (s, _CONTROL_EXEC[s.op_type](s, device))
                       for s in _plan(graph, self.ctx)]
        self._inputs = {
            n: torch.empty(self.ctx.var_shape(n),
                           dtype=graph.vars[n].precision.torch_dtype, device=device)
            for n in graph.inputs}
        self._outputs: Optional[Dict[str, torch.Tensor]] = None
        self._graphs: List[Optional[torch.cuda.CUDAGraph]] = []
        self._env: Dict[str, Any] = {}
        self._stager = InputStager() if device.type == "cuda" else None
        self._ptrs = {k: v.data_ptr() for k, v in weights.items()}
        self._lock = threading.RLock()

    @property
    def captured(self) -> bool:
        return bool(self._graphs)

    @property
    def n_graphs(self) -> int:
        """CUDA graphs captured: one a segment, and those of the blocks of
        the control-flow ops."""
        return (sum(g is not None for g in self._graphs)
                + sum(ex.n_graphs for s, ex in
                      (st for st in self._steps if isinstance(st, tuple))))

    @property
    def n_segments(self) -> int:
        """Segments of the plan: the CUDA graphs a call replays on the card,
        the control-flow blocks' apart."""
        return sum(1 for st in self._steps
                   if not isinstance(st, (tuple, _HostStep)))

    @property
    def input_shapes(self) -> Dict[str, tuple]:
        """The static input buffers' shapes (the context's: a rank's
        data shard)."""
        return {n: tuple(t.shape) for n, t in self._inputs.items()}

    @property
    def control_flow(self) -> List[Any]:
        """The control-flow executors, in order (a ``_While`` reports its
        last call's ``trips``)."""
        return [st[1] for st in self._steps if isinstance(st, tuple)]

    def clone(self) -> "CompiledGraph":
        """The same function with its own static buffers and its own graphs
        (captured on its first call), sharing the weights and the per-op
        constants."""
        return CompiledGraph(self.graph, self.device, self.weights, self.ctx,
                             self.carried)

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

    def warm_up(self, weights: Dict[str, Any], inputs: Dict[str, Any]) -> None:
        """Load `inputs` and run the segments eagerly once on the static
        buffers (the first call does this before it captures)."""
        self._check_weights(weights)
        with self._lock, _CAPTURE_LOCK:
            load_static_inputs("compiled graph", inputs, self._inputs, self._stager)
            self._eager()

    def _start_env(self) -> Dict[str, Any]:
        return _load_env(self.graph, self.weights, self._inputs, self.device)

    def _finish(self, env: Dict[str, Any]) -> Dict[str, Any]:
        """The outputs over `env`; one that shares storage with a static
        input buffer or a weight is copied, so a block's outputs never
        alias its state, unless it is the buffer of its own name and that
        name is carried."""
        own = list(self._inputs.values()) + list(self.weights.values())
        return {n: (v.clone() if _shares_storage(v, own) and not (
                    n in self.carried and v is self._inputs[n]) else v)
                for n, v in _public_outputs(self.graph, env).items()}

    def capture(self) -> None:
        """Capture each segment over the static buffers as a CUDA graph
        (after :meth:`warm_up`; the first call does both); the first one
        also holds the inputs' island rounding.  Where control flow or a
        host step follows a segment, the segment is replayed and the step
        run once, so that every later capture reads real values."""
        with self._lock, _CAPTURE_LOCK, fp32_exact():
            island = island_dtype(self.graph)
            env: Dict[str, Any] = {}
            graphs: List[Optional[torch.cuda.CUDAGraph]] = []
            outputs = None
            for i, step in enumerate(self._steps):
                last = i == len(self._steps) - 1
                if isinstance(step, tuple):  # never the first step (_plan)
                    self._control(*step, env)
                    graphs.append(None)
                    continue
                if isinstance(step, _HostStep):  # nor this
                    step(env)
                    graphs.append(None)
                    continue
                if i == 0 and not step.ops and island is None:
                    env.update(self._start_env())  # nothing to capture
                    graphs.append(None)
                    continue

                def segment(i=i, step=step, last=last):
                    if i == 0:
                        env.update(self._start_env())
                    step(env)
                    return self._finish(env) if last else None

                graph, outputs = capture_cuda_graph(segment)
                if not last:
                    graph.replay()
                graphs.append(graph)
            if outputs is None:
                outputs = self._finish(env)
            self._env, self._outputs, self._graphs = env, outputs, graphs

    def _control(self, op: OpNode, ex, env: Dict[str, Any]) -> None:
        outs = ex(_resolve_inputs(op, env))
        for slot, arrs in outs.items():
            for n, a in zip(op.outputs.get(slot, []), arrs):
                env[n] = a

    def _eager(self) -> Dict[str, torch.Tensor]:
        """One run over the static buffers, the segments eager, the control
        flow between them: the warm-up on the card, every run on the CPU."""
        with fp32_exact():
            env = self._start_env()
            for step in self._steps:
                if isinstance(step, tuple):
                    self._control(*step, env)
                else:
                    step(env)  # a segment or a host step
            return self._finish(env)

    def _execute(self) -> Dict[str, torch.Tensor]:
        """One run over the static buffers: the captured graphs replayed
        (on the CPU the segments run eagerly), the control flow run
        between them.  Returns the output tensors themselves."""
        if not self._graphs:
            return self._eager()
        with fp32_exact():
            for step, graph in zip(self._steps, self._graphs):
                if graph is not None:
                    graph.replay()
                elif isinstance(step, tuple):
                    self._control(*step, self._env)
                elif isinstance(step, _HostStep):
                    step.replay()
            return self._outputs

    def run_static(self) -> Dict[str, torch.Tensor]:
        """Run on what the static input buffers hold (a control-flow block's
        state); the first call on the card warms up and captures.  Returns
        the output tensors themselves, overwritten by the next call."""
        with self._lock:
            if self.device.type == "cuda" and not self._graphs:
                with _CAPTURE_LOCK:
                    self._eager()  # the warm-up
                self.capture()
            return self._execute()

    def __call__(self, weights: Dict[str, Any],
                 inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        self._check_weights(weights)
        with self._lock:
            load_static_inputs("compiled graph", inputs, self._inputs, self._stager)
            return {n: v.clone() for n, v in self.run_static().items()}


def compile_graph(graph: Graph, *, device: torch.device
                  ) -> Tuple[CompiledGraph, Dict[str, torch.Tensor]]:
    """Stage the weights and compile the graph: ``(fn, weights)``, as the
    reference returns ``(jax.jit(fn), weights)``; call ``fn(weights,
    inputs)``.  The ``GenRuntimeProgram`` + first-``Run`` analog.  Raises
    ``ValueError`` for a graph holding an impl that synchronises with the
    host (the ``"torch"`` NMS), naming the op; ``while`` and
    ``conditional_block`` are run on the host between captured segments
    (:class:`CompiledGraph`)."""
    weights = stage_weights(graph, device)
    return CompiledGraph(graph, device, weights), weights
