"""Sharded inference over a (data, model) mesh of ``torch.distributed`` ranks.

Port of ``paddle_lite_tpu/parallel/sharding.py``.  The reference annotates
weights and inputs with ``NamedSharding`` and lets XLA's GSPMD partitioner
propagate shardings and insert collectives.  The port has no partitioner,
so :class:`ShardedPredictor` states its rule: one process a rank (a
device), rank ``r`` at data index ``r // model`` and model index
``r % model``, and

- each rank runs the graph on its data shard of the batch (every graph
  input split on its leading axis where ``input_pspec`` splits it);
- an op whose weight ``weight_pspec`` splits on its output channels (a
  group-1 conv2d's filter, an fc / mul weight) runs its own tagged impl on
  the rank's slice of the weight, its bias and its per-channel scales
  (the int8 GEMM family as ``"tp_cuda"``, ``tp_ops``; the stem's fp32 3x3
  conv as ``"torch"``; a residual input sliced to the rank's channels
  first), and its output channels are then ``all_gather``ed over the
  model group: the op's host step (``ShardedContext.host_step``);
- every other op runs replicated, on whole weights: a depthwise bias that
  ``weight_pspec`` marks ``"model"`` stays whole, as the depthwise op reads
  every channel;
- the outputs are gathered over the data group, so every rank returns the
  whole result.  The vars split over the batch are those computed from the
  inputs whose leading dim is the batch (:func:`batch_vars`).

``weight_pspec`` / ``input_pspec`` are the reference's rules as pure
functions of the graph and the mesh's shape, returning the spec as a tuple
(``()`` replicated, ``(None, "model")`` split on the last of two axes);
:func:`shard_weights` places a weight split only where the op that reads it
runs split (:func:`split_ops`).

**Collectives.**  NCCL moves device tensors.  Rule for gloo, fixed: *a
collective over a gloo group runs on a host copy, explicitly* (``.cpu()``
before, ``.to(device)`` after, :meth:`Mesh._host`), whether or not the
installed torch's gloo takes CUDA tensors; nothing is caught and retried
another way.  A group of one rank runs no collective.

**Compiled.**  The run is compiled, as the reference's is under
``jax.jit`` (``core.executor.CompiledGraph`` over the rank's context): on
the card the first request captures the graph as CUDA graphs, cut after
each split op, and later requests replay them; each gather runs on the
host between two replays (through the host copy on gloo), from the
tensor the first graph wrote into a static buffer the second reads.  A
model group of one rank gathers nothing, so the 1x1 and Dx1 meshes are
one graph a rank; MobileNetV1 at 1x2 (15 split ops) is 16.  NCCL
collectives are cut the same way, not captured in a graph.  The data
group's gather of the outputs follows the compiled call.
``compiled=False`` runs the eager loop (``core.executor.build_callable``,
the gather inside it after each split op), the only path with the
``capture(name, value)`` hook.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.executor import CompiledGraph, ExecutionContext, build_callable, stage_weights
from ..core.ir import Graph, OpNode
from ..runtime.predictor import validate_inputs
from . import distributed

Spec = Tuple[Optional[str], ...]

GLOO_RULE = "backend gloo => each collective runs on a host copy, explicitly"


@dataclasses.dataclass
class Mesh:
    """A (data, model) mesh over the process group, as one rank sees it:
    its shape, its rank and device, the backend, and the two subgroups it
    belongs to (None where the axis has one rank)."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, Any]

    def index(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self.rank // self.shape["model"] if axis == "data" \
            else self.rank % self.shape["model"]

    def parts(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def local_range(self, n: int, axis: str) -> range:
        """This rank's equal part of ``range(n)``, split over `axis`."""
        parts = self.parts(axis)
        if n % parts:
            raise ValueError(f"size {n} not divisible by {axis}={parts}")
        step = n // parts
        return range(self.index(axis) * step, (self.index(axis) + 1) * step)

    def local_slice(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's equal part of `t` along `dim`, split over `axis`."""
        r = self.local_range(t.shape[dim], axis)
        return t if len(r) == t.shape[dim] else t.narrow(dim, r.start, len(r))

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective moves: a host copy under gloo (the
        module's rule), the tensor itself under NCCL."""
        return t.cpu() if self.backend == "gloo" else t.contiguous()

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
        """The parts of every rank along `axis`, concatenated on `dim`."""
        group = self.groups[axis]
        if group is None:
            return t
        src = self._host(t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.parts(axis))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over `axis` (integer sums wrap as int32 does)."""
        group = self.groups[axis]
        if group is None:
            return t
        buf = self._host(t).clone()
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over `axis`, each rank keeping its part of the rows."""
        group = self.groups[axis]
        if group is None:
            return t
        parts = self.parts(axis)
        if t.shape[0] % parts:
            raise ValueError(f"M={t.shape[0]} not divisible by {axis}={parts}")
        src = self._host(t).contiguous()
        out = torch.empty((t.shape[0] // parts,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.to(t.device)


def _device_list(devices, world: int) -> List[torch.device]:
    """One device a rank: `devices` (a bare ``"cuda"`` read as ``cuda:0``),
    else ``cuda:{local rank}``."""
    if devices is None:
        local = distributed.local_world_size()
        return [torch.device("cuda", r % local) for r in range(world)]
    devs = [torch.device(d) for d in devices]
    return [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d
            for d in devs]


@dataclasses.dataclass
class MeshConfig:
    """Mesh axes for inference serving (``MeshConfig`` of the reference)."""

    data: int = 1
    model: int = 1

    def build(self, devices: Optional[Sequence] = None, backend: Optional[str] = None) -> Mesh:
        """The mesh over the process group (one process, no group: a 1x1
        mesh).  `devices` lists one device a rank (default ``cuda:{local
        rank}``); two ranks may share a device only on gloo.  `backend` is
        the subgroups' (default: the group's own).  Every rank calls it,
        with the same arguments."""
        n = self.data * self.model
        world = distributed.world_size()
        if n != world:
            raise ValueError(f"mesh {self.data}x{self.model} needs {n} devices, have {world}")
        devs = _device_list(devices, world)
        if len(devs) != world:
            raise ValueError(f"devices lists {len(devs)} devices for {world} ranks")
        if backend is None:
            backend = dist.get_backend() if dist.is_initialized() else "gloo"
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r}: the mesh runs on 'gloo' or 'nccl'")
        if backend == "nccl":
            seen: Dict[torch.device, int] = {}
            for r, d in enumerate(devs):
                if d.type != "cuda":
                    raise ValueError(f"NCCL runs on CUDA devices; rank {r} lists {d}")
                if d in seen:
                    raise ValueError(f"device {d} is listed for ranks {seen[d]} and {r}: "
                                     f"NCCL takes one rank a card; two ranks share a card "
                                     f"only on gloo")
                seen[d] = r
        rank = distributed.rank()
        groups: Dict[str, Any] = {"data": None, "model": None}
        # every rank makes every subgroup, in one order (new_group's contract)
        if self.model > 1:
            for d in range(self.data):
                ranks = [d * self.model + m for m in range(self.model)]
                g = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    groups["model"] = g
        if self.data > 1:
            for m in range(self.model):
                ranks = [d * self.model + m for d in range(self.data)]
                g = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    groups["data"] = g
        return Mesh({"data": self.data, "model": self.model}, rank, devs[rank], backend, groups)


# ---- the reference's specs ---------------------------------------------------

def _divisible(dim: int, parts: int) -> bool:
    return parts > 0 and dim % parts == 0


def weight_pspec(graph: Graph, name: str, mesh) -> Spec:
    """The reference's spec of one weight under channel-major TP
    (``sharding.py:57-79``): a group-1 conv2d filter (HWIO) split on O, an
    fc / mul weight (K, O) on O, a conv / depthwise / fc bias on its one
    axis, each where the model axis divides it; else replicated ``()``.
    `mesh` is a :class:`Mesh` or a shape dict."""
    model_parts = mesh_shape(mesh).get("model", 1)
    if model_parts == 1:
        return ()
    v = graph.vars[name]
    for op in v.use_ops:
        t = op.op_type
        if t == "conv2d" and op.maybe_input("Filter") == name:
            if int(op.attrs.get("groups", 1)) == 1 and _divisible(v.shape[3], model_parts):
                return (None, None, None, "model")
        elif t in ("fc", "mul") and name in (op.maybe_input("W"), op.maybe_input("Y")):
            if len(v.shape) == 2 and _divisible(v.shape[1], model_parts):
                return (None, "model")
        elif t in ("conv2d", "depthwise_conv2d", "fc") and name == op.maybe_input("Bias"):
            if _divisible(v.shape[-1], model_parts):
                return ("model",)
    return ()


def input_pspec(graph: Graph, name: str, mesh) -> Spec:
    """The reference's spec of one graph input (``sharding.py:82-88``): split
    on its leading (batch) axis over ``data`` where that divides it."""
    data_parts = mesh_shape(mesh).get("data", 1)
    v = graph.vars[name]
    if data_parts > 1 and v.shape and _divisible(v.shape[0], data_parts):
        return tuple(["data"] + [None] * (len(v.shape) - 1))
    return ()


def mesh_shape(mesh) -> Dict[str, int]:
    """The axis sizes of a :class:`Mesh` or of a shape dict."""
    return mesh.shape if isinstance(mesh, Mesh) else dict(mesh)


# ---- the executor's rule -----------------------------------------------------

SPLIT_SLOTS = {"conv2d": "Filter", "fc": "W", "mul": "Y"}


def split_ops(graph: Graph, mesh) -> FrozenSet[int]:
    """Ids of the ops that run on their output-channel shard: those whose
    weight ``weight_pspec`` splits on its last axis, and whose weight is
    stored unpacked (a W4 weight packs two values a byte: its op runs
    replicated)."""
    out = set()
    for op in graph.ops:
        slot = SPLIT_SLOTS.get(op.op_type)
        w = op.maybe_input(slot) if slot else None
        if not w or w not in graph.weights:
            continue
        spec = weight_pspec(graph, w, mesh)
        q = graph.vars[w].quant
        if spec and spec[-1] == "model" and (q is None or q.pack_axis is None):
            out.add(op.id)
    return frozenset(out)


def split_weights(graph: Graph, mesh) -> Dict[str, int]:
    """Weight name -> the axis split over ``model``: the weight and the bias
    of every op of :func:`split_ops`, each split on its last axis."""
    ids = split_ops(graph, mesh)
    out: Dict[str, int] = {}
    for op in graph.ops:
        if op.id not in ids:
            continue
        w = op.input(SPLIT_SLOTS[op.op_type])
        out[w] = len(graph.vars[w].shape) - 1
        b = op.maybe_input("Bias")
        if b and b in graph.weights:
            out[b] = len(graph.vars[b].shape) - 1
    return out


def _batch_split(graph: Graph, mesh) -> bool:
    """Whether the batch is split over ``data``: every graph input splits
    under ``input_pspec`` (else every rank runs the whole batch)."""
    return mesh_shape(mesh).get("data", 1) > 1 and all(
        input_pspec(graph, n, mesh) for n in graph.inputs)


def batch_vars(graph: Graph) -> FrozenSet[str]:
    """The vars that hold batch rows under a data split: those computed
    from the graph inputs (through any chain of ops) whose leading dim is
    the batch.  Such a var is taken to be batch-major, as every var of the
    CNN zoo is; a var computed from the inputs with another axis leading
    (time-major) and that axis as long as the batch would be mis-split."""
    b = graph.vars[graph.inputs[0]].shape[0]
    dep = set(graph.inputs)
    for op in graph.topological_order():
        if any(n in dep for n in op.input_names()):
            dep.update(op.output_names())
    return frozenset(n for n in dep if graph.vars[n].shape and graph.vars[n].shape[0] == b)


def _tensor(x) -> torch.Tensor:
    """A tensor, or a numpy array viewed as one (no copy)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def shard_weights(graph: Graph, weights: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's weights as tensors (numpy arrays or tensors in): the
    rank's slice of every weight of :func:`split_weights`, the rest whole."""
    split = split_weights(graph, mesh)
    return {name: (mesh.local_slice(_tensor(w), "model", split[name]).contiguous()
                   if name in split else _tensor(w))
            for name, w in weights.items()}


def shard_inputs(graph: Graph, inputs: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows, as tensors, of every input that ``input_pspec``
    splits over ``data`` (where every input splits; else the whole
    batch)."""
    split = _batch_split(graph, mesh)
    return {name: mesh.local_slice(_tensor(x), "data", 0) if split else _tensor(x)
            for name, x in inputs.items()}


@dataclasses.dataclass
class ShardedContext(ExecutionContext):
    """A rank's execution context: its mesh, var quant and shapes as the
    rank holds them, each split op's impl on the rank's channels, and the
    gather of its output channels over the model axis as its host step."""

    mesh: Optional[Mesh] = None
    split: FrozenSet[int] = frozenset()
    split_vars: Dict[str, int] = dataclasses.field(default_factory=dict)
    batch_vars: FrozenSet[str] = frozenset()  # split over "data" (:func:`batch_vars`)
    local_batch: int = 0
    tp_impls: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def var_quant(self, name: str):
        q = self.graph.vars[name].quant
        dim = self.split_vars.get(name)
        if q is None or dim is None or not q.per_channel or len(q.scale) == 1:
            return q
        if q.axis != dim:
            raise ValueError(f"{name}: per-channel scales on axis {q.axis}, split on {dim}")
        r = self.mesh.local_range(len(q.scale), "model")
        return dataclasses.replace(q, scale=q.scale[r.start:r.stop])

    def var_shape(self, name: str):
        shape = tuple(self.graph.vars[name].shape)
        dim = self.split_vars.get(name)
        if dim is not None:
            return shape[:dim] + (shape[dim] // self.mesh.parts("model"),) + shape[dim + 1:]
        if name in self.batch_vars:
            return (self.local_batch,) + shape[1:]
        return shape

    def impl_for(self, op: OpNode):
        tag = op.attrs.get("kernel")
        impl = self.tp_impls[op.op_type] if tag == "tp_cuda" else super().impl_for(op)
        if op.id not in self.split or not op.maybe_input("ResidualData"):
            return impl
        mesh = self.mesh

        def split_impl(ctx, op_, ins):
            ins = dict(ins, ResidualData=[mesh.local_slice(r, "model", r.ndim - 1)
                                          for r in ins["ResidualData"]])
            return impl(ctx, op_, ins)

        return split_impl

    def host_step(self, op: OpNode):
        """A split op's output channels gathered over the model group."""
        if op.id not in self.split:
            return None
        mesh = self.mesh
        return lambda t: mesh.all_gather(t, "model", dim=-1)


class ShardedPredictor:
    """Multi-process predictor: data parallel over the batch × tensor
    parallel over conv / fc output channels, one rank a device (the
    module's rule).  Every rank of the group constructs it with the same
    graph and calls :meth:`run` with the same whole feed; each returns the
    whole result.

    With `use_tp_cuda` (the reference's ``use_tp_pallas``), int8 fc / mul
    / unpadded 1x1 convs run as ``"tp_cuda"`` (``tp_ops.assign_tp_kernels``:
    kernel 1 on the rank's column shard,
    ``tp_cuda.column_parallel_int8_matmul``); without it nothing is
    retagged there and every ``"cuda"`` tag becomes ``"torch"``, so every
    op runs its plain impl.  Like the reference, it retags the graph it is
    given.  `compiled` (the default) runs the request as captured CUDA
    graphs cut at the collectives (the module's rule); ``compiled=False``
    runs the eager loop, where ``capture(name, value)`` sees every
    intermediate as this rank holds it (its rows, channels gathered).
    With `compiled`, `capture` raises.  ``use_tp_cuda=False`` is the plain
    sharded path that the tests hold the kernels' path against, as the
    reference's tests use ``use_tp_pallas=False``; no entry point sets it."""

    def __init__(self, graph: Graph, mesh_config: MeshConfig, devices=None, *,
                 backend: Optional[str] = None, use_tp_cuda: bool = True,
                 compiled: bool = True, capture=None):
        from .tp_ops import TP_IMPLS, assign_tp_kernels

        if compiled and capture is not None:
            raise ValueError("ShardedPredictor: capture= sees the eager loop's "
                             "intermediates; pass compiled=False with it")
        self.graph = graph
        self.mesh = mesh_config.build(devices, backend=backend)
        self.device = self.mesh.device
        if use_tp_cuda:
            self.n_tp_ops = assign_tp_kernels(graph, self.mesh)
        else:
            self.n_tp_ops = 0
            for op in graph.ops:
                if op.attrs.get("kernel") == "cuda":
                    op.attrs["kernel"] = "torch"
        rows = batch_vars(graph) if _batch_split(graph, self.mesh) else frozenset()
        self._ctx = ShardedContext(
            graph=graph, device=self.device, mesh=self.mesh,
            split=split_ops(graph, self.mesh), split_vars=split_weights(graph, self.mesh),
            batch_vars=rows, local_batch=(graph.vars[graph.inputs[0]].shape[0]
                                          // self.mesh.parts("data") if rows else 0),
            tp_impls=TP_IMPLS)
        with self._on_device():
            self._weights = shard_weights(graph, stage_weights(graph, self.device), self.mesh)
        self._fn = (CompiledGraph(graph, self.device, self._weights, self._ctx) if compiled
                    else build_callable(graph, device=self.device, capture=capture,
                                        context=self._ctx))

    def _on_device(self):
        """The rank's card as the current device (the kernels launch there)."""
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    @property
    def n_split_ops(self) -> int:
        return len(self._ctx.split)

    def _compiled(self) -> CompiledGraph:
        if not isinstance(self._fn, CompiledGraph):
            raise ValueError("ShardedPredictor: built with compiled=False, it "
                             "captures nothing")
        return self._fn

    def warm_up(self, inputs: Dict[str, Any]) -> None:
        """What the compiled run's first request does before it captures,
        alone: `inputs` (the whole feed) loaded and the graph run eagerly
        once on the static buffers, its gathers between the segments."""
        validate_inputs(self.graph, inputs)
        local = shard_inputs(self.graph, inputs, self.mesh)
        with self._on_device():
            self._compiled().warm_up(self._weights, local)

    def capture(self) -> None:
        """Capture the compiled run's CUDA graphs (on the card, after
        :meth:`warm_up`; the first :meth:`run` does both)."""
        with self._on_device():
            self._compiled().capture()

    @property
    def input_shapes(self) -> Dict[str, tuple]:
        """The compiled run's static input buffers' shapes: the rank's
        shard of each input."""
        return self._compiled().input_shapes

    @property
    def n_segments(self) -> int:
        """The compiled plan's segments (a CUDA graph each on the card); 0
        for the eager loop."""
        return self._fn.n_segments if isinstance(self._fn, CompiledGraph) else 0

    @property
    def n_graphs(self) -> int:
        """CUDA graphs captured so far (none before the first request, on
        the CPU or for the eager loop)."""
        return self._fn.n_graphs if isinstance(self._fn, CompiledGraph) else 0

    @property
    def batch_vars(self) -> FrozenSet[str]:
        """The vars each rank holds only its data shard of (:func:`batch_vars`;
        empty where the batch is not split)."""
        return self._ctx.batch_vars

    def run(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The whole batch's outputs, on this rank's device."""
        validate_inputs(self.graph, inputs)
        local = shard_inputs(self.graph, inputs, self.mesh)
        with self._on_device():
            out = self._fn(self._weights, local)
            return {k: self.mesh.all_gather(v, "data", dim=0) if k in self.batch_vars else v
                    for k, v in out.items()}

    def __call__(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return self.run(inputs)
