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
  may not fill the context's cache.  The loaded program runs the loop as
  the HOP's own loop, reading the condition once a trip.
- ``fp32_exact`` (TF32 off) is a setting of the process, not of the
  program: :func:`load_compiled`'s runner sets it around every call, as the
  predictor does.
- The loaded program runs compiled, as the reference's ``exported.call``
  is one XLA computation: on the card the first call warms the module up
  once on static input buffers and captures it as one CUDA graph, which
  later calls replay (:class:`LoadedProgram`).  A program that holds
  ``while_loop`` or ``cond`` reads a condition on the host, so it cannot
  be one graph: it keeps the module's own call, and says so
  (``captured`` False).

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
from typing import Dict, List

import numpy as np
import torch

from .. import ops  # noqa: F401  (registers the plt:: custom ops)
from ..core.device import DeviceLike, InputStager, fp32_exact, resolve_device
from ..core.executor import (build_callable, capture_cuda_graph, load_static_inputs,
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
    tensor: foldable where it returns a tensor."""
    target = node.target
    if node.op != "call_function" or not isinstance(target, torch._ops.OpOverload):
        return False
    if target.namespace != "aten" or target._schema.is_mutable \
            or torch.Tag.nondeterministic_seeded in target.tags:
        return False
    ins = node.all_input_nodes
    return bool(ins) and all(n.op == "get_attr" and n.target in constants
                             and _attr(module, n.target).device.type == "cpu" for n in ins)


def _attr(module: torch.nn.Module, target: str):
    return functools.reduce(getattr, target.split("."), module)


def _fold_host_constants(module: torch.fx.GraphModule, constants) -> int:
    """Compute once, at load, each op of `module`'s graph that reads only
    host tensor constants (:func:`_foldable`; `constants` names them), and
    read its result from a constant of its own: a per-op constant traced
    from a numpy array (a per-channel scale) is a host tensor that the
    program copies (``lift_fresh_copy``) and moves to the device on every
    call, and a CUDA graph cannot capture a copy from pageable host
    memory.  The values are the same.  Returns the ops folded."""
    graph = module.graph
    constants = set(constants)
    folded = 0
    for node in list(graph.nodes):
        if not _foldable(node, module, constants):
            continue
        args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs),
                                             lambda n: _attr(module, n.target))
        value = node.target(*args, **kwargs)
        if not isinstance(value, torch.Tensor):  # a metadata check stays
            continue
        name = f"_plt_folded_{folded}"
        module.register_buffer(name, value, persistent=False)
        constants.add(name)
        with graph.inserting_before(node):
            node.replace_all_uses_with(graph.get_attr(name))
        graph.erase_node(node)
        folded += 1
    graph.eliminate_dead_code()
    module.recompile()
    return folded


class LoadedProgram:
    """``run(inputs_dict) -> outputs_dict`` of a loaded program, over static
    input buffers of its meta's shapes and dtypes: a call copies the
    inputs in (an input of another shape, or a missing one, raises) and
    returns fresh outputs (one ``clone()`` a call), as ``CompiledGraph``
    does.  On the card, without control flow (:attr:`captured`), the first
    call runs the module once (the warm-up: the kernel libraries load and
    set up) and captures it as one ``torch.cuda.CUDAGraph`` with TF32 off;
    every call replays it.  A capture that fails raises.  Otherwise (on
    the CPU, or a program with ``while_loop`` / ``cond``) each call runs
    the module on the same static buffers.  Calls are serialised."""

    def __init__(self, ep, meta: dict):
        self.program = ep
        self.meta = meta
        self.device = resolve_device(meta["device"])
        self.module = ep.module()
        self.n_folded = _fold_host_constants(self.module, ep.constants)
        self.control_flow = _control_flow_ops(ep)
        self.captured = self.device.type == "cuda" and not self.control_flow
        self._inputs = {n: torch.empty(s["shape"], dtype=getattr(torch, s["dtype"]),
                                       device=self.device)
                        for n, s in meta["inputs"].items()}
        self._stager = InputStager() if self.device.type == "cuda" else None
        self._graph = None
        self._outputs = None
        self._lock = threading.Lock()

    @property
    def n_graphs(self) -> int:
        """CUDA graphs captured: 1 after the first call where
        :attr:`captured`, else 0."""
        return int(self._graph is not None)

    def __call__(self, inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        with self._lock, torch.no_grad(), fp32_exact():
            load_static_inputs("loaded program", inputs, self._inputs, self._stager)
            if not self.captured:
                out = self.module(self._inputs)
            else:
                if self._graph is None:
                    self._graph, self._outputs = capture_cuda_graph(
                        lambda: self.module(self._inputs), warm_up=True)
                self._graph.replay()
                out = self._outputs
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
