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
  once on static input buffers and captures it as one CUDA graph, and
  later calls replay it (:class:`LoadedProgram`).  A ``while_loop`` is a
  WHILE node of that graph and a ``cond`` two IF nodes
  (``core/conditional_nodes``, the port's own library), as
  ``core/executor.compile_graph`` runs ``while`` / ``conditional_block``:
  the conditions are evaluated on the card (:class:`_ControlFlow`).

The program's call signature is ``run(inputs_dict) -> outputs_dict``, as
the reference's; inputs may be numpy arrays or tensors, each of its
input's shape, and are cast to the graph's input precision and copied to
the program's device; the outputs are fresh tensors.
"""

from __future__ import annotations

import functools
import io
import json
import threading
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import ops  # noqa: F401  (registers the plt:: custom ops)
from ..core.device import DeviceLike, InputStager, fp32_exact, resolve_device
from ..core import conditional_nodes
from ..core.executor import (CONTROL_FLOW, CompiledGraph, ExecutionContext, build_callable,
                             capture_cuda_graph, load_static_inputs, refuse_host_syncing,
                             stage_weights)
from ..core.ir import Graph

META = "plt_meta.json"


class _Program(torch.nn.Module):
    """The eager program of `graph` with its staged weights as buffers.
    Where `graph` holds control flow, every block's per-op constants are
    made first, outside the trace, by a warm-up of the compiled path on
    `example` (each block runs, both sides of a branch): made inside a
    block that Dynamo traces, a constant is a tensor of the block's own
    graph, which ``torch.export.save`` refuses; made before, it is an
    operand the trace lifts, as the block's weights are."""

    def __init__(self, graph: Graph, device: torch.device,
                 example: Dict[str, torch.Tensor]):
        super().__init__()
        weights = stage_weights(graph, device)
        self.names = list(weights)
        for i, v in enumerate(weights.values()):
            self.register_buffer(f"w{i}", v)
        ctx = ExecutionContext(graph=graph, device=device)
        if any(op.op_type in CONTROL_FLOW for op in graph.ops):
            CompiledGraph(graph, device, weights, ctx).warm_up(weights, example)
        self.fn = build_callable(graph, device=device, context=ctx)

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
        ep = torch.export.export(_Program(graph, dev, example), (example,), strict=False)
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


class _ControlFlow(TorchDispatchMode):
    """Runs a loaded program's ``while_loop`` and ``cond`` as the compiled
    predictor runs ``while`` and ``conditional_block``
    (``core/executor._While``, ``_ConditionalBlock``), through
    ``core/conditional_nodes``: under a capture a ``while_loop`` is a WHILE
    node and a ``cond`` two IF nodes of the one graph being captured, the
    blocks' ops inline in their bodies; elsewhere (the CPU, the warm-up)
    the same steps with the condition read on the host.  A loop's state
    lives in buffers of its own, and each trip runs the body, copies its
    outputs into the state and computes the next condition (the exported
    ``cond_fn``, which holds ``max_iters``) into one flag; both sides of a
    ``cond`` write one set of outputs.  `warm` also runs each body and both
    branches once whatever the condition, so that nothing first runs
    inside a capture."""

    supports_higher_order_operators = True

    def __init__(self, warm: bool = False):
        super().__init__()
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

        conditional_nodes.while_node(flag, trip)
        return tuple(state)

    def _cond(self, pred, true_fn, false_fn, operands):
        if self.warm:
            true_fn(*operands)
            false_fn(*operands)
        if not conditional_nodes.capturing(pred.device):
            return tuple((true_fn if bool(pred) else false_fn)(*operands))
        outs: List[torch.Tensor] = []

        def taken():
            outs.extend(true_fn(*operands))

        def passed():
            for o, v in zip(outs, false_fn(*operands)):
                o.copy_(v)

        conditional_nodes.if_node(pred, taken, passed)
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
    captures it as one CUDA graph with TF32 off; every call replays it.
    Its ``while_loop`` and ``cond`` ops (:attr:`control_flow`) are
    conditional nodes of that graph (:class:`_ControlFlow`), as
    ``compile_graph`` runs ``while`` / ``conditional_block``: a request
    reads no condition back.  A capture that fails raises.  On the CPU each
    call runs the module on the same static buffers, its control flow
    through the same steps as host loops."""

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
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[Dict[str, torch.Tensor]] = None
        self._lock = threading.Lock()

    @property
    def n_graphs(self) -> int:
        """CUDA graphs captured: 0 before the first call on the card, then 1."""
        return int(self._graph is not None)

    def _run(self, mode: _ControlFlow):
        if not self.control_flow:
            return self.module(self._inputs)
        with mode:
            return self.module(self._inputs)

    def _record(self) -> None:
        self._graph, self._out = capture_cuda_graph(
            lambda: self._run(_ControlFlow()),
            warm_up=lambda: self._run(_ControlFlow(warm=True)))

    def __call__(self, inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        with self._lock, torch.no_grad(), fp32_exact():
            load_static_inputs("loaded program", inputs, self._inputs, self._stager)
            if not self.captured:
                out = self._run(_ControlFlow())
            else:
                if self._graph is None:
                    self._record()
                self._graph.replay()
                out = self._out
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
