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
later call replays it (:class:`CompiledGraph`); its ``while`` /
``conditional_block`` ops are conditional nodes of that graph
(``core/conditional_nodes``), as the reference's ``lax.while_loop`` /
``lax.cond`` run inside its one XLA computation.  The execution context
may name cuts: ops after which a step runs on the host between two
replays (:meth:`ExecutionContext.host_step`: a sharded run's
collectives).

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

from . import conditional_nodes, trace
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
        is one segment."""
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
               host_steps: bool = True, compiled: bool = False):
    """``run(env, warm=False)``: `ops` in order over the name-keyed `env`,
    each output written into it (rounded to the island dtype, then through
    the context's host step where it names one and `host_steps` is set: the
    eager loop; a compiled segment runs the steps between replays).  With
    `compiled`, each ``while`` / ``conditional_block`` runs through an
    executor of its own (:class:`_While`, :class:`_ConditionalBlock`: a
    conditional node under a capture; `warm` runs every side of its
    block), listed in ``run.control``.  Impls are resolved here, so an
    unknown tag raises now."""
    impls, control = [], []
    for op in ops:
        if compiled and op.op_type in CONTROL_FLOW:
            ex = _CONTROL_EXEC[op.op_type](op, ctx)
            control.append(ex)
            impls.append(lambda c, o, ins, warm, ex=ex: ex(ins, warm))
        else:
            impl = ctx.impl_for(op)
            impls.append(lambda c, o, ins, warm, impl=impl: impl(c, o, ins))
    steps = [ctx.host_step(op) if host_steps else None for op in ops]
    island = island_dtype(graph)

    def run(env: Dict[str, Any], warm: bool = False) -> None:
        for op, impl, step in zip(run.ops, impls, steps):
            outs = impl(ctx, op, _resolve_inputs(op, env), warm)
            for slot, arrs in outs.items():
                for n, a in zip(op.outputs.get(slot, []), arrs):
                    a = _to_island(a, island)
                    env[n] = a if step is None else step(a)
                    if capture is not None:
                        capture(n, env[n])

    run.ops = ops
    run.control = control
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


def block_context(ctx: ExecutionContext, op: OpNode, key: str = "block"
                  ) -> Tuple[ExecutionContext, Dict[str, torch.Tensor]]:
    """The context and the staged weights of the graph in ``op.attrs[key]``
    (a control-flow block, a subgraph's region), once per op of `ctx`:
    shared by the compiled path's executors and the eager and traced
    runners of ``ops/control_flow``, so the per-op constants that a
    warm-up makes are those an export's trace of the block reads."""
    g = op.attrs[key]
    return ctx.const(op, f"nested_{key}_context", lambda: (
        ExecutionContext(graph=g, device=ctx.device), stage_weights(g, ctx.device)))


@trace.setup_span("setup.stage_weights")
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
# per-op constants that clones share.  Reentrant: a loaded program warms
# up and captures under it
_CAPTURE_LOCK = threading.RLock()


def capture_cuda_graph(fn: Callable[[], Any], *,
                       warm_up: Optional[Callable[[], Any]] = None
                       ) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """``fn()`` captured as one ``torch.cuda.CUDAGraph`` under the
    process's capture lock, after one eager call of `warm_up` where given
    (the kernel libraries load and set up, which no capture may do).
    The conditional nodes that ``fn()`` makes (``core/conditional_nodes``)
    are part of the graph, their bodies' memory pool kept as long as it.
    Returns the graph and what the captured ``fn()`` returned: tensors
    that every replay rewrites.  A capture that fails raises."""
    with _CAPTURE_LOCK:
        if warm_up is not None:
            warm_up()
        graph = torch.cuda.CUDAGraph()
        with conditional_nodes.scope() as bodies:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn()
        bodies.keep_with(graph)
    trace.count("graph.captures")
    return graph, out


# ops the compiled path runs as conditional nodes of the graph being
# captured (a WHILE node; an IF node each way), their blocks' ops inline in
# the bodies: nothing is read back to the host
CONTROL_FLOW = ("while", "conditional_block")


def nested_graphs(op: OpNode) -> List[Graph]:
    """The graphs an op carries in its attrs (control-flow blocks, a
    subgraph's region)."""
    return [v for v in op.attrs.values() if isinstance(v, Graph)]


def host_syncing_ops(graph: Graph, cut: bool = True) -> List[str]:
    """"op_type (tag)" of every op of `graph`, or of a graph nested in it,
    whose impl waits for the card on the host (registered with
    ``syncs_host=True``), less the control-flow ops (:data:`CONTROL_FLOW`)
    that the compiled path runs as conditional nodes (`cut`): those of the
    top level and of the control-flow blocks.  A ``subgraph``'s region runs
    its ops' eager impls inline, so control flow there counts."""
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
    """The topological order cut after each op for which `ctx` names a host
    step: lists of ops (a segment, one CUDA graph each, control flow
    included) and :class:`_HostStep`s, in order; the first step is a
    segment, maybe empty."""
    steps: list = [[]]
    for op in graph.topological_order():
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
        with trace.span("graph.host_step"):
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


class _Block:
    """A control-flow op's block in the compiled path: its staged weights,
    a context of its own (its per-op constants; :func:`block_context` of
    the op in the parent's context `ctx`) and its ops, run inline wherever
    the op runs (in a conditional node's body under a capture), nested
    control flow through executors of their own.  A loop's block (`state`)
    holds the loop state in static buffers (:attr:`_inputs`): a var that
    the block outputs unchanged under its own name (`carried`) is its
    buffer itself; any other output that shares storage with a state
    buffer is copied, so writing the state back never reads a half-written
    one."""

    def __init__(self, op: OpNode, ctx: ExecutionContext, carried=frozenset(),
                 state: bool = False):
        block = op.attrs["block"]
        device = ctx.device
        self.graph = block
        self.device = device
        self.ctx, self.weights = block_context(ctx, op)
        self.carried = frozenset(carried)
        self._ops = _op_runner(block, block.topological_order(), self.ctx,
                               host_steps=False, compiled=True)
        self._inputs = {n: torch.empty(block.vars[n].shape,
                                       dtype=block.vars[n].precision.torch_dtype,
                                       device=device)
                        for n in block.inputs} if state else {}

    @property
    def control_flow(self) -> List[Any]:
        """The block's control-flow executors, in order."""
        return list(self._ops.control)

    def __call__(self, inputs: Dict[str, Any], warm: bool = False) -> Dict[str, Any]:
        env = _load_env(self.graph, self.weights, inputs, self.device)
        self._ops(env, warm)
        out = _public_outputs(self.graph, env)
        state = list(self._inputs.values())
        return {n: (v.clone() if _shares_storage(v, state) and not (
                    n in self.carried and v is self._inputs[n]) else v)
                for n, v in out.items()}


class _While:
    """A ``while`` op in the compiled path, on static state buffers (its
    block's, :class:`_Block`): a call copies the state in, zeroes a device
    trip counter and computes ``flag = cond != 0 and counter < max_iters``
    (the reference's condition, ``ops/control_flow.py:77-82`` there), then
    runs a trip while `flag` holds: the block's ops, its outputs copied
    back into the state (a carried var is its own buffer), ``counter += 1``
    and `flag` again.  Under a capture that is one WHILE node
    (``conditional_nodes.while_node``), elsewhere a host loop.  The final
    state buffers are the op's outputs.  `warm` (the warm-up before a
    capture) first runs the block once on copies of the state, so that a
    loop of no trip still fills its constants."""

    def __init__(self, op: OpNode, ctx: ExecutionContext):
        block = op.attrs["block"]
        if len(block.outputs) != len(block.inputs):
            raise ValueError("while block must output one var per state input")
        device = ctx.device
        self.names = list(block.inputs)
        self.outs = list(block.outputs)
        self.body = _Block(op, ctx, state=True,
                           carried={n for n, o in zip(self.names, self.outs) if n == o})
        self.cond = self.names[int(op.attrs.get("cond_index", 0))]
        self.max_iters = int(op.attrs.get("max_iters", 1000))
        self.counter = torch.zeros((), dtype=torch.int32, device=device)
        self.flag = torch.zeros((), dtype=torch.bool, device=device)

    @property
    def trips(self) -> int:
        """Trips of the last run of the loop, read from the device counter
        (only when asked: a request never reads it)."""
        return int(self.counter)

    def _next_flag(self) -> None:
        c = self.body._inputs[self.cond].reshape(-1)[0] != 0
        torch.logical_and(c, self.counter < self.max_iters, out=self.flag)

    def _trip(self) -> None:
        state = self.body._inputs
        out = self.body(state)
        for n, o in zip(self.names, self.outs):
            if out[o] is not state[n]:
                state[n].copy_(out[o])
        self.counter.add_(1)
        self._next_flag()

    def __call__(self, ins: Dict[str, List[Any]], warm: bool = False) -> Dict[str, List[Any]]:
        state = self.body._inputs
        for n, x in zip(self.names, ins["X"]):
            state[n].copy_(x)
        if warm:
            self.body({n: s.clone() for n, s in state.items()}, warm=True)
        self.counter.zero_()
        self._next_flag()
        conditional_nodes.while_node(self.flag, self._trip)
        return {"Out": [state[n] for n in self.names]}


class _ConditionalBlock:
    """A ``conditional_block`` op in the compiled path: where ``Cond``
    holds, its block runs on the inputs, else they pass through, either
    way into one set of static output buffers.  Under a capture that is
    two IF nodes, on ``Cond`` and on its negation
    (``conditional_nodes.if_node``), elsewhere a branch on the host.
    `warm` runs both sides first."""

    def __init__(self, op: OpNode, ctx: ExecutionContext):
        block = op.attrs["block"]
        self.body = _Block(op, ctx)
        self.names = list(block.inputs)
        self.outs = list(block.outputs)
        self.buffers: Optional[List[torch.Tensor]] = None

    def __call__(self, ins: Dict[str, List[Any]], warm: bool = False) -> Dict[str, List[Any]]:
        xs = ins["Input"]
        if self.buffers is None:  # at the first run: the warm-up on the card
            self.buffers = [torch.empty_like(x) for x in xs]

        def taken(warm: bool = False) -> None:
            out = self.body(dict(zip(self.names, xs)), warm)
            for buf, o in zip(self.buffers, self.outs):
                buf.copy_(out[o])

        def passed() -> None:
            for buf, x in zip(self.buffers, xs):
                buf.copy_(x)

        if warm:
            taken(warm=True)
            passed()
        pred = ins["Cond"][0].reshape(-1)[0] != 0
        conditional_nodes.if_node(pred, taken, passed)
        return {"Out": list(self.buffers)}


_CONTROL_EXEC = {"while": _While, "conditional_block": _ConditionalBlock}


class CompiledGraph:
    """``fn(weights, inputs) -> outputs`` over static buffers: the
    ``jax.jit``-compiled function of the reference.

    On ``"cuda"`` the first call copies the inputs into the static input
    buffers, runs the graph eagerly once on them (the warm-up: it fills the
    per-op constants, folded scales and repacked weights, and loads and
    sets up the kernel libraries, none of which may happen inside a
    capture; each control-flow block runs, a loop's on copies of its state
    and both sides of a ``conditional_block``), then captures it as one
    ``torch.cuda.CUDAGraph`` with TF32 off; every call replays it.  A
    ``while`` is a WHILE node of that graph and a ``conditional_block`` two
    IF nodes (``core/conditional_nodes``), their blocks' ops inline in the
    nodes' bodies on static state buffers (:class:`_While`,
    :class:`_ConditionalBlock`): the conditions are evaluated on the card
    and a request reads nothing back.  The graph is cut only after each op
    for which the context names a host step
    (:meth:`ExecutionContext.host_step`, a sharded run's collective): the
    step runs on the host between the two replays, from the tensor the
    first segment wrote into a static buffer the second reads
    (:class:`_HostStep`).  A graph without one is one segment, one CUDA
    graph, with or without control flow.  ``subgraph`` stays inline in its
    segment.  The static input buffers have the context's shapes
    (:meth:`ExecutionContext.var_shape`: a rank's data shard).  A capture
    that fails raises; nothing falls back to the eager loop or to reading
    a condition on the host.  :attr:`n_graphs` counts the CUDA graphs
    captured.  On ``"cpu"`` there is no CUDA graph: the segments run
    eagerly on the same static buffers, the control flow through the same
    executors as host loops, so the contract is the same on both devices:

    - inputs are cast to the input var's precision; an input of another
      shape raises;
    - the outputs are fresh tensors (one ``clone()`` a call), so a later
      call never changes a result already handed out;
    - ``weights`` must be the tensors the function was compiled with (the
      graph holds their pointers); any other dict raises.

    Calls on one instance are serialised; :meth:`clone` gives a function
    with its own buffers and graphs that shares the weights and constants.
    """

    def __init__(self, graph: Graph, device: torch.device,
                 weights: Dict[str, torch.Tensor],
                 ctx: Optional[ExecutionContext] = None):
        refuse_host_syncing(graph)
        self.graph = graph
        self.device = device
        self.weights = weights
        self.ctx = ctx or ExecutionContext(graph=graph, device=device)
        self._steps = [_op_runner(graph, s, self.ctx, host_steps=False, compiled=True)
                       if isinstance(s, list) else s for s in _plan(graph, self.ctx)]
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
        """CUDA graphs captured: one a segment."""
        return sum(g is not None for g in self._graphs)

    @property
    def n_segments(self) -> int:
        """Segments of the plan: the CUDA graphs a call replays on the card."""
        return sum(1 for st in self._steps if not isinstance(st, _HostStep))

    @property
    def input_shapes(self) -> Dict[str, tuple]:
        """The static input buffers' shapes (the context's: a rank's
        data shard)."""
        return {n: tuple(t.shape) for n, t in self._inputs.items()}

    @property
    def control_flow(self) -> List[Any]:
        """The top level's control-flow executors, in order (a ``_While``
        reads its last run's ``trips`` from the card)."""
        return [ex for st in self._steps if not isinstance(st, _HostStep)
                for ex in st.control]

    def clone(self) -> "CompiledGraph":
        """The same function with its own static buffers and its own graphs
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

    def warm_up(self, weights: Dict[str, Any], inputs: Dict[str, Any]) -> None:
        """Load `inputs` and run the graph eagerly once on the static
        buffers, every control-flow block included (the first call does
        this before it captures)."""
        self._check_weights(weights)
        with self._lock, _CAPTURE_LOCK:
            load_static_inputs("compiled graph", inputs, self._inputs, self._stager)
            self._warm_up()

    def _start_env(self) -> Dict[str, Any]:
        return _load_env(self.graph, self.weights, self._inputs, self.device)

    def _finish(self, env: Dict[str, Any]) -> Dict[str, Any]:
        """The outputs over `env`; one that shares storage with a static
        input buffer or a weight is copied."""
        own = list(self._inputs.values()) + list(self.weights.values())
        return {n: (v.clone() if _shares_storage(v, own) else v)
                for n, v in _public_outputs(self.graph, env).items()}

    def capture(self) -> None:
        """Capture each segment over the static buffers as a CUDA graph
        (after :meth:`warm_up`; the first call does both); the first one
        also holds the inputs' island rounding.  Where a host step follows
        a segment, the segment is replayed and the step run once, so that
        the next capture reads real values."""
        with self._lock, _CAPTURE_LOCK, fp32_exact(), trace.setup_span("setup.capture"):
            island = island_dtype(self.graph)
            env: Dict[str, Any] = {}
            graphs: List[Optional[torch.cuda.CUDAGraph]] = []
            outputs = None
            for i, step in enumerate(self._steps):
                last = i == len(self._steps) - 1
                if isinstance(step, _HostStep):  # never the first step (_plan)
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

    def _warm_up(self) -> None:
        with trace.setup_span("setup.warm_up"):
            self._eager(warm=True)

    def _eager(self, warm: bool = False) -> Dict[str, torch.Tensor]:
        """One run over the static buffers, the segments eager, each
        control-flow op's conditions read on the host: the warm-up on the
        card (`warm`: every block run), every run on the CPU (each segment
        a ``graph.replay`` span, as a replay is on the card)."""
        with fp32_exact():
            env = self._start_env()
            for step in self._steps:
                if isinstance(step, _HostStep):
                    step(env)
                elif warm:
                    step(env, warm)
                else:
                    with trace.span("graph.replay"):
                        step(env)
            return self._finish(env)

    def _execute(self) -> Dict[str, torch.Tensor]:
        """One run over the static buffers: the captured graphs replayed
        (on the CPU the segments run eagerly), the host steps run between
        them.  Returns the output tensors themselves."""
        if not self._graphs:
            return self._eager()
        with fp32_exact():
            for step, graph in zip(self._steps, self._graphs):
                if graph is not None:
                    with trace.span("graph.replay"):
                        graph.replay()
                elif isinstance(step, _HostStep):
                    step.replay()
            return self._outputs

    def run_static(self) -> Dict[str, torch.Tensor]:
        """Run on what the static input buffers hold; the first call on the
        card warms up and captures.  Returns the output tensors
        themselves, overwritten by the next call."""
        with self._lock:
            if self.device.type == "cuda" and not self._graphs:
                with _CAPTURE_LOCK:
                    self._warm_up()
                self.capture()
            return self._execute()

    def __call__(self, weights: Dict[str, Any],
                 inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        self._check_weights(weights)
        with self._lock:
            with trace.span("predictor.stage_inputs"):
                load_static_inputs("compiled graph", inputs, self._inputs, self._stager)
            out = self.run_static()
            with trace.span("predictor.clone_outputs"):
                return {n: v.clone() for n, v in out.items()}


def compile_graph(graph: Graph, *, device: torch.device
                  ) -> Tuple[CompiledGraph, Dict[str, torch.Tensor]]:
    """Stage the weights and compile the graph: ``(fn, weights)``, as the
    reference returns ``(jax.jit(fn), weights)``; call ``fn(weights,
    inputs)``.  The ``GenRuntimeProgram`` + first-``Run`` analog.  Raises
    ``ValueError`` for a graph holding an impl that synchronises with the
    host (the ``"torch"`` NMS), naming the op; ``while`` and
    ``conditional_block`` run inside the CUDA graph as conditional nodes
    (:class:`CompiledGraph`)."""
    weights = stage_weights(graph, device)
    return CompiledGraph(graph, device, weights), weights
