"""AOT program export — the serialized-program half of the ``.nb`` story.

Port of ``paddle_lite_tpu/formats/aot.py`` (``:26-62``), whose analog of the
reference's ``gen_code`` path is a serialized StableHLO export of the
jitted model (``jax.export``).  Here it is ``torch.export``: the eager
program (``core/executor.build_callable``) of an optimized graph is traced
once into an ``ExportedProgram`` with the weights baked in as its buffers,
and ``torch.export.save`` / ``load`` write and read it.  Loading rebuilds
no graph and runs no pass and no calibration.

- The ``"cuda"`` impls reach their kernels through ctypes, which
  ``torch.export`` cannot trace; they go through the ``plt::`` custom ops
  (``ops/kernels/custom_ops.py``), which the program holds as opaque ops.
  Those ops register when ``paddle_lite_tpu_torch.ops`` is imported (this
  module imports it), so a loaded program finds them.  On the card they
  launch the kernels, on the CPU they run the plain versions.
- The program is traced on the device asked for and runs there: its
  buffers and its constants live on that device.
- A graph holding an impl that synchronises with the host is refused with
  ``compile_graph``'s message, in a control-flow block too.
- Control flow is exported, as the reference's ``jax.export`` carries
  ``lax.while_loop`` (``formats/aot.py:27-42`` there): ``while`` becomes
  ``torch._higher_order_ops.while_loop`` over the state vars and a trip
  count of its own, which ``max_iters`` bounds (the condition is state var
  ``cond_index`` and the trip count below ``max_iters``), and
  ``conditional_block`` becomes ``torch.cond`` (``ops/control_flow.py``).
  Dynamo traces each block whole; inside it an op's per-op constants are
  traced into the block (``ExecutionContext.const``), since a traced block
  may not fill the context's cache.
- ``fp32_exact`` (TF32 off) is a setting of the process, not of the
  program: :func:`load_compiled`'s runner sets it around every call, as the
  predictor does.
- The loaded program runs compiled, as the reference's ``exported.call``
  is one XLA computation: on the card the first call warms the module up
  once on static input buffers and captures it, and later calls replay
  the capture (:class:`LoadedProgram`).  A program without control flow
  is one CUDA graph.  The card's torch offers no conditional graph node,
  so a program that holds ``while_loop`` or ``cond`` is cut at each, as
  ``core/executor.compile_graph`` cuts a graph at its control flow: each
  straight run of ops and each block's body a CUDA graph, the condition
  read on the host between replays (:class:`_ControlFlow`).

The program's call signature is ``run(inputs_dict) -> outputs_dict``, as
the reference's; inputs may be numpy arrays or tensors, each of its
input's shape, and are cast to the graph's input precision and copied to
the program's device; the outputs are fresh tensors.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import ops  # noqa: F401  (registers the plt:: custom ops)
from ..core.device import DeviceLike, InputStager, fp32_exact, resolve_device
from ..core.executor import (build_callable, capture_session, load_static_inputs,
                             refuse_host_syncing, stage_weights)
from ..core.ir import Graph

META = "plt_meta.json"


class _Program(torch.nn.Module):
    """The eager program of `graph` with its staged weights as buffers."""

    def __init__(self, graph: Graph, device: torch.device):
        super().__init__()
        weights = stage_weights(graph, device)
        self.names = list(weights)
        for i, v in enumerate(weights.values()):
            self.register_buffer(f"w{i}", v)
        self.fn = build_callable(graph, device=device)

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        weights = {n: getattr(self, f"w{i}") for i, n in enumerate(self.names)}
        return self.fn(weights, inputs)


def export_program(graph: Graph, *, device: DeviceLike = None):
    """The ``torch.export.ExportedProgram`` of the optimized `graph` on
    `device` (the card unless the CPU is asked for) and its meta (input
    names, shapes and dtypes, the device)."""
    refuse_host_syncing(graph)
    dev = resolve_device(device)
    example = {n: torch.zeros(graph.vars[n].shape, dtype=graph.vars[n].precision.torch_dtype,
                              device=dev) for n in graph.inputs}
    with torch.no_grad(), fp32_exact():
        ep = torch.export.export(_Program(graph, dev), (example,), strict=False)
    ep.example_inputs = None  # else saved with the program: a batch of zeros
    meta = {"device": dev.type, "outputs": list(graph.outputs),
            "inputs": {n: {"shape": list(t.shape), "dtype": str(t.dtype).split(".")[1]}
                       for n, t in example.items()}}
    return ep, meta


def export_compiled(graph: Graph, *, device: DeviceLike = None) -> bytes:
    """Serialize the traced program (weights baked in) to bytes whose
    loaded call signature is ``run(inputs_dict) -> outputs_dict``."""
    ep, meta = export_program(graph, device=device)
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={META: json.dumps(meta)})
    return buf.getvalue()


def _control_flow_ops(ep) -> List[str]:
    """The higher-order ops (``while_loop``, ``cond``) of an exported
    program, its blocks' graphs included, by name."""
    return sorted({n.target.name() for m in ep.graph_module.modules()
                   if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
                   if isinstance(n.target, torch._ops.HigherOrderOperator)})


def _foldable(node: torch.fx.Node, module: torch.nn.Module, constants) -> bool:
    """A pure, deterministic aten op whose every input node reads one of
    `constants` (names of `module`'s constant attributes) holding a host
    tensor, or that has none (a factory): foldable where it returns a
    tensor, a factory where it returns a host tensor."""
    target = node.target
    if node.op != "call_function" or not isinstance(target, torch._ops.OpOverload):
        return False
    if target.namespace != "aten" or target._schema.is_mutable \
            or torch.Tag.nondeterministic_seeded in target.tags:
        return False
    return all(n.op == "get_attr" and n.target in constants
               and _attr(module, n.target).device.type == "cpu" for n in node.all_input_nodes)


def _attr(module: torch.nn.Module, target: str):
    return functools.reduce(getattr, target.split("."), module)


def _block_operands(node: torch.fx.Node):
    """(the block graphs, [(placeholder position, operand)] of the operands
    that each block reads unchanged on every run) of a ``cond`` or
    ``while_loop`` node: every operand of a ``cond``, a loop's
    additional inputs (its carried state changes each trip)."""
    if node.target is torch.ops.higher_order.cond:
        return node.args[1:3], list(enumerate(node.args[3]))
    if node.target is torch.ops.higher_order.while_loop:
        carried, additional = node.args[2], node.args[3]
        return node.args[0:2], [(len(carried) + j, a) for j, a in enumerate(additional)]
    return (), []


def _fold_host_constants(module: torch.fx.GraphModule, constants) -> int:
    """Compute once, at load, each op of `module`'s graph that reads only
    host tensor constants (:func:`_foldable`; `constants` names them), and
    read its result from a constant of its own: a per-op constant traced
    from a numpy array (a per-channel scale) is a host tensor that the
    program copies (``lift_fresh_copy``) and moves to the device on every
    call, and a CUDA graph cannot capture a copy from pageable host
    memory.  Inside a ``cond`` or ``while_loop`` block (traced whole), a
    host constant that the block reads unchanged on every run is passed in
    as an operand and moved there, and a numpy constant is a host factory
    (``full``): the block reads such an operand as a constant of its own
    and is folded the same way.  The values are the same.  Returns the
    ops folded."""
    graph = module.graph
    constants = set(constants)
    folded = 0
    for node in list(graph.nodes):
        if not _foldable(node, module, constants):
            continue
        args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs),
                                             lambda n: _attr(module, n.target))
        value = node.target(*args, **kwargs)
        if not isinstance(value, torch.Tensor) or (  # a metadata check stays
                not node.all_input_nodes and value.device.type != "cpu"):
            continue
        name = f"_plt_folded_{folded}"
        module.register_buffer(name, value, persistent=False)
        constants.add(name)
        with graph.inserting_before(node):
            node.replace_all_uses_with(graph.get_attr(name))
        graph.erase_node(node)
        folded += 1
    for node in graph.nodes:
        blocks, operands = _block_operands(node)
        for block in blocks:
            sub = _attr(module, block.target)
            inputs = [n for n in sub.graph.nodes if n.op == "placeholder"]
            host = set()
            for pos, operand in operands:
                if not (isinstance(operand, torch.fx.Node) and operand.op == "get_attr"
                        and operand.target in constants
                        and _attr(module, operand.target).device.type == "cpu"):
                    continue
                name = f"_plt_host_{pos}"
                sub.register_buffer(name, _attr(module, operand.target), persistent=False)
                with sub.graph.inserting_after(inputs[-1]):
                    inputs[pos].replace_all_uses_with(sub.graph.get_attr(name))
                host.add(name)
            folded += _fold_host_constants(sub, host)
    graph.eliminate_dead_code()
    module.recompile()
    return folded


class _Recording:
    """A function's run on the card recorded as CUDA graphs cut at its
    control flow: a graph for each straight run of ops and, between two,
    the host step of the ``while_loop`` or ``cond`` that cut them.  A call
    replays the steps in order and returns what the function returned at
    the capture (tensors that every replay rewrites)."""

    def __init__(self, capture: "_Capture"):
        self.capture = capture
        self.steps: List[Callable[[], Any]] = []
        self.out: Any = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None

    def begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(self.capture.pool, capture_error_mode="thread_local")

    def end(self) -> None:
        graph, self._graph = self._graph, None
        graph.capture_end()
        self.capture.graphs.append(graph)
        self.steps.append(graph.replay)

    def __call__(self) -> Any:
        for step in self.steps:
            step()
        return self.out


class _Capture:
    """One capture of a loaded program: its recordings share one memory
    pool; :attr:`graphs` holds every CUDA graph captured."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self._current: Optional[_Recording] = None

    def record(self, fn: Callable[[], Any]) -> _Recording:
        """`fn()` captured as a :class:`_Recording`; a capture that fails
        raises, the graph it was capturing ended first."""
        rec, outer = _Recording(self), self._current
        self._current = rec
        rec.begin()
        try:
            rec.out = fn()
        except BaseException:
            if rec._graph is not None:
                with contextlib.suppress(RuntimeError):
                    rec._graph.capture_end()
            raise
        finally:
            self._current = outer
        rec.end()
        return rec

    def split(self, make_step: Callable[[], Callable[[], None]]) -> None:
        """End the graph being captured, append the host step that
        `make_step()` returns (it records the blocks it replays), and begin
        the next graph."""
        rec = self._current
        rec.end()
        rec.steps.append(make_step())
        rec.begin()


class _ControlFlow(TorchDispatchMode):
    """Runs a loaded program's ``while_loop`` and ``cond`` as the compiled
    predictor runs ``while`` and ``conditional_block``
    (``core/executor._While``, ``_ConditionalBlock``): the condition is
    read on the host; a loop's state lives in buffers of its own, and each
    trip runs the body, copies its outputs into the state and computes the
    next condition into one flag.  Under a `capture`, the graph being
    captured ends at the op (after the state is copied in and the first
    condition computed), each block is captured as a recording of its own
    (a trip; each branch, both writing one set of outputs) and the host
    step between two graphs replays them; without one (the CPU, the
    warm-up) the same steps run eagerly.  `warm` also runs each body and
    both branches once whatever the condition, so that nothing first runs
    inside a capture."""

    supports_higher_order_operators = True

    def __init__(self, capture: Optional[_Capture] = None, warm: bool = False):
        super().__init__()
        self.capture = capture
        self.warm = warm

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.higher_order.while_loop:
            with self:  # the mode is popped around this call; blocks nest
                return self._while(*args, **kwargs)
        if func is torch.ops.higher_order.cond:
            with self:
                return self._cond(*args, **kwargs)
        return func(*args, **kwargs)

    def _host_step(self, make_step: Callable[[], Callable[[], None]]) -> None:
        if self.capture is None:
            make_step()()
        else:
            self.capture.split(make_step)

    def _block(self, fn: Callable[[], Any]) -> Callable[[], Any]:
        return fn if self.capture is None else self.capture.record(fn)

    def _while(self, cond_fn, body_fn, carried, additional):
        # a carried input the body passes through is never written: it is
        # its own state buffer
        passed = getattr(body_fn, PASSED_THROUGH, ())
        state = [c if i in passed else c.clone() for i, c in enumerate(carried)]
        flag = cond_fn(*state, *additional)
        if self.warm:
            body_fn(*[s.clone() for s in state], *additional)

        def trip():
            for s, v in zip(state, body_fn(*state, *additional)):
                if v is not s:  # a carried input passed through (_pass_carried_through)
                    s.copy_(v)
            flag.copy_(cond_fn(*state, *additional))

        def make_step():
            body = self._block(trip)

            def loop():
                while bool(flag):
                    body()
            return loop

        self._host_step(make_step)
        return tuple(state)

    def _cond(self, pred, true_fn, false_fn, operands):
        if self.warm:
            true_fn(*operands)
            false_fn(*operands)
        if self.capture is None:
            return tuple((true_fn if bool(pred) else false_fn)(*operands))
        outs: List[torch.Tensor] = []

        def make_step():
            taken = self._block(lambda: tuple(true_fn(*operands)))
            outs.extend(taken.out)
            passed = self._block(lambda: [o.copy_(v) for o, v in
                                          zip(outs, false_fn(*operands))])
            return lambda: (taken if bool(pred) else passed)()

        self._host_step(make_step)
        return tuple(outs)


PASSED_THROUGH = "_plt_passed_through"  # a body's attribute: the positions given back
_PASS_THROUGH = (torch.ops.aten.clone.default, torch.ops.aten.to.dtype,
                 torch.ops.aten.to.dtype_layout, torch.ops.aten.to.device)


def _same_tensor_type(a: torch.fx.Node, b: torch.fx.Node) -> bool:
    va, vb = a.meta.get("val"), b.meta.get("val")
    return (isinstance(va, torch.Tensor) and isinstance(vb, torch.Tensor)
            and va.dtype == vb.dtype and va.device == vb.device)


def _pass_carried_through(module: torch.fx.GraphModule) -> int:
    """In each ``while_loop`` body of `module`, give back a carried input
    that the body returns unchanged (cast to its own dtype on its own
    device, then cloned, as ``while_loop`` requires of a body) as the input
    itself, and name its position in the body's :data:`PASSED_THROUGH`:
    the loop then neither copies it in, out nor back, as
    ``executor._While`` leaves a carried var in its buffer.  The values are
    the same.  Returns the outputs so given back."""
    passed = 0
    for gm in [m for m in module.modules() if isinstance(m, torch.fx.GraphModule)]:
        for node in gm.graph.nodes:
            if node.target is not torch.ops.higher_order.while_loop:
                continue
            body = _attr(gm, node.args[1].target)
            inputs = [n for n in body.graph.nodes if n.op == "placeholder"]
            out = next(n for n in reversed(body.graph.nodes) if n.op == "output")
            values = list(out.args[0])
            given = set()
            for i in range(len(node.args[2])):
                src = values[i]
                while (src.op == "call_function" and src.target in _PASS_THROUGH
                       and _same_tensor_type(src, src.args[0])):
                    src = src.args[0]
                if src is inputs[i] and values[i] is not src:
                    values[i] = src
                    given.add(i)
            setattr(body, PASSED_THROUGH, frozenset(given))
            passed += len(given)
            out.args = (tuple(values),)
            body.graph.eliminate_dead_code()
            body.recompile()
    return passed


class LoadedProgram:
    """``run(inputs_dict) -> outputs_dict`` of a loaded program, over static
    input buffers of its meta's shapes and dtypes: a call copies the
    inputs in (an input of another shape, or a missing one, raises) and
    returns fresh outputs (one ``clone()`` a call), as ``CompiledGraph``
    does.  Calls are serialised.

    On the card (:attr:`captured`) the first call runs the module once
    (the warm-up: the kernel libraries load and set up, and each
    control-flow block runs, both sides of a ``cond`` included) and
    captures it with TF32 off; every call replays the capture.  A program
    without control flow is one CUDA graph.  One with ``while_loop`` or
    ``cond`` (:attr:`control_flow`) is cut at each, as ``compile_graph``
    cuts a graph at ``while`` / ``conditional_block``: a CUDA graph for
    each straight run of ops, each block's body a CUDA graph of its own,
    the condition read on the host between replays (:class:`_ControlFlow`;
    :attr:`n_graphs` counts them all).  A capture that fails raises.  On
    the CPU each call runs the module on the same static buffers, its
    control flow through the same steps without graphs."""

    def __init__(self, ep, meta: dict):
        self.program = ep
        self.meta = meta
        self.device = resolve_device(meta["device"])
        self.module = ep.module()
        self.n_folded = _fold_host_constants(self.module, ep.constants)
        self.control_flow = _control_flow_ops(ep)
        self.n_passed_through = _pass_carried_through(self.module)
        self.captured = self.device.type == "cuda"
        self._inputs = {n: torch.empty(s["shape"], dtype=getattr(torch, s["dtype"]),
                                       device=self.device)
                        for n, s in meta["inputs"].items()}
        self._stager = InputStager() if self.device.type == "cuda" else None
        self._capture: Optional[_Capture] = None
        self._replay: Optional[_Recording] = None
        self._lock = threading.Lock()

    @property
    def n_graphs(self) -> int:
        """CUDA graphs captured: 0 before the first call on the card."""
        return len(self._capture.graphs) if self._capture is not None else 0

    def _run(self, mode: _ControlFlow):
        if not self.control_flow:
            return self.module(self._inputs)
        with mode:
            return self.module(self._inputs)

    def _record(self) -> None:
        with capture_session():
            self._run(_ControlFlow(warm=True))
            capture = _Capture()
            self._replay = capture.record(lambda: self._run(_ControlFlow(capture)))
            self._capture = capture

    def __call__(self, inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        with self._lock, torch.no_grad(), fp32_exact():
            load_static_inputs("loaded program", inputs, self._inputs, self._stager)
            if not self.captured:
                out = self._run(_ControlFlow())
            else:
                if self._replay is None:
                    self._record()
                out = self._replay()
            return {k: v.clone() for k, v in out.items()}


def load_compiled(blob: bytes) -> LoadedProgram:
    """Returns ``run(inputs_dict) -> outputs_dict`` (a
    :class:`LoadedProgram`) from an exported blob."""
    extra = {META: ""}
    ep = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return LoadedProgram(ep, json.loads(extra[META]))


def save_compiled(graph: Graph, path: str, **kw) -> None:
    with open(path, "wb") as f:
        f.write(export_compiled(graph, **kw))


def load_compiled_file(path: str):
    with open(path, "rb") as f:
        return load_compiled(f.read())
