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

The program's call signature is ``run(inputs_dict) -> outputs_dict``, as
the reference's; inputs may be numpy arrays or tensors and are cast to the
graph's input precision and moved to the program's device.
"""

from __future__ import annotations

import io
import json
from typing import Dict

import numpy as np
import torch

from .. import ops  # noqa: F401  (registers the plt:: custom ops)
from ..core.device import DeviceLike, fp32_exact, resolve_device
from ..core.executor import build_callable, refuse_host_syncing, stage_weights
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


def load_compiled(blob: bytes):
    """Returns ``run(inputs_dict) -> outputs_dict`` from an exported blob."""
    extra = {META: ""}
    ep = torch.export.load(io.BytesIO(blob), extra_files=extra)
    meta = json.loads(extra[META])
    dev = resolve_device(meta["device"])
    specs = {n: getattr(torch, s["dtype"]) for n, s in meta["inputs"].items()}
    module = ep.module()

    def run(inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        feed = {n: (v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))).to(device=dev, dtype=specs[n]) for n, v in inputs.items()}
        with torch.no_grad(), fp32_exact():
            return module(feed)

    run.program = ep
    run.meta = meta
    return run


def save_compiled(graph: Graph, path: str, **kw) -> None:
    with open(path, "wb") as f:
        f.write(export_compiled(graph, **kw))


def load_compiled_file(path: str):
    with open(path, "rb") as f:
        return load_compiled(f.read())
