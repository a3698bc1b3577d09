"""Graph IR — analog of Paddle-Lite's MIR SSA graph.

Copy of ``paddle_lite_tpu/core/ir.py`` (numpy only), kept in this package
so that it imports nothing of the JAX package.  A bipartite graph whose
nodes alternate between *op statements* and *variable arguments*
(``lite/core/mir/{node,ssa_graph}``), built by :class:`GraphBuilder`,
rewritten by passes (``paddle_lite_tpu_torch.passes``) and run op by op by
the eager executor (``core/executor.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .types import DataLayout, Precision, QuantInfo, TensorType


@dataclasses.dataclass
class VarNode:
    """A tensor-valued variable (MIR ``Node::Arg`` analog)."""

    name: str
    shape: Tuple[int, ...]
    ttype: TensorType = dataclasses.field(default_factory=TensorType)
    is_weight: bool = False
    quant: Optional[QuantInfo] = None
    # producer/consumer links are maintained by Graph
    def_op: Optional["OpNode"] = None
    use_ops: List["OpNode"] = dataclasses.field(default_factory=list)

    @property
    def precision(self) -> Precision:
        return self.ttype.precision

    def __repr__(self) -> str:  # keep graph dumps readable
        q = " q" if self.quant else ""
        w = " w" if self.is_weight else ""
        return f"Var({self.name}:{self.ttype.precision.value}{self.shape}{w}{q})"


@dataclasses.dataclass
class OpNode:
    """An operator statement (MIR ``Node::Stmt`` analog).

    ``inputs``/``outputs`` map slot names (e.g. "X", "Filter", "Out" — kept
    close to fluid slot naming for importer parity) to lists of variable
    names.  ``attrs`` is the op's attribute dict (the ``op_params.h`` analog,
    schemaless by design).  Passes may stamp extra keys; by convention:

    - ``enable_int8``: bool — op selected for the int8 kernel path
    - ``fuse_act``: str — fused activation ("relu", "relu6", "hard_swish", …)
    - ``kernel``: str — implementation picked by the kernel-pick pass
      ("cuda" | "torch"); absent means the op's default impl.
    """

    op_type: str
    inputs: Dict[str, List[str]]
    outputs: Dict[str, List[str]]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    id: int = -1

    def input(self, slot: str, i: int = 0) -> str:
        return self.inputs[slot][i]

    def output(self, slot: str, i: int = 0) -> str:
        return self.outputs[slot][i]

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def maybe_input(self, slot: str) -> Optional[str]:
        ns = self.inputs.get(slot)
        return ns[0] if ns else None

    def __repr__(self) -> str:
        return f"Op#{self.id}({self.op_type})"


class Graph:
    """Whole-model dataflow graph plus its weight store.

    Combines the roles of the reference's ``cpp::ProgramDesc`` + ``Scope``
    (weights) + ``mir::SSAGraph``: one structure the whole pipeline shares.
    Weights are host numpy arrays until the predictor stages them to device.
    """

    def __init__(self, name: str = "model"):
        self.name = name
        self.vars: Dict[str, VarNode] = {}
        self.ops: List[OpNode] = []
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.weights: Dict[str, np.ndarray] = {}
        # graph-level execution metadata (e.g. "island_dtype": "bfloat16" —
        # run non-int8 float regions in bf16; persisted in the artifact)
        self.meta: Dict[str, Any] = {}
        self._next_op_id = 0
        self._uniq = 0

    # ---- construction ----------------------------------------------------
    def add_var(
        self,
        name: str,
        shape: Sequence[int],
        precision: Precision = Precision.FP32,
        layout: DataLayout = DataLayout.NHWC,
        is_weight: bool = False,
    ) -> VarNode:
        if name in self.vars:
            raise ValueError(f"duplicate var {name!r}")
        v = VarNode(
            name=name,
            shape=tuple(int(s) for s in shape),
            ttype=TensorType(precision, layout),
            is_weight=is_weight,
        )
        self.vars[name] = v
        return v

    def add_weight(self, name: str, value: np.ndarray) -> VarNode:
        value = np.asarray(value)
        prec = {
            np.dtype(np.float32): Precision.FP32,
            np.dtype(np.int8): Precision.INT8,
            np.dtype(np.int16): Precision.INT16,
            np.dtype(np.int32): Precision.INT32,
            np.dtype(np.int64): Precision.INT64,
        }.get(value.dtype, Precision.FP32)
        v = self.add_var(name, value.shape, precision=prec, is_weight=True)
        self.weights[name] = value
        return v

    def add_op(
        self,
        op_type: str,
        inputs: Dict[str, List[str]],
        outputs: Dict[str, List[str]],
        attrs: Optional[Dict[str, Any]] = None,
    ) -> OpNode:
        op = OpNode(op_type, dict(inputs), dict(outputs), dict(attrs or {}))
        op.id = self._next_op_id
        self._next_op_id += 1
        self.ops.append(op)
        self._link(op)
        return op

    def unique_name(self, base: str) -> str:
        while True:
            self._uniq += 1
            name = f"{base}__{self._uniq}"
            if name not in self.vars:
                return name

    # ---- link maintenance ------------------------------------------------
    def _link(self, op: OpNode) -> None:
        for n in op.input_names():
            self.vars[n].use_ops.append(op)
        for n in op.output_names():
            self.vars[n].def_op = op

    def rebuild_links(self) -> None:
        """Recompute def/use chains after passes mutate the op list."""
        for v in self.vars.values():
            v.def_op = None
            v.use_ops = []
        for op in self.ops:
            self._link(op)

    # ---- queries ---------------------------------------------------------
    def var(self, name: str) -> VarNode:
        return self.vars[name]

    def producers(self, op: OpNode) -> List[OpNode]:
        return [
            self.vars[n].def_op
            for n in op.input_names()
            if self.vars[n].def_op is not None
        ]

    def consumers(self, op: OpNode) -> List[OpNode]:
        out: List[OpNode] = []
        for n in op.output_names():
            out.extend(self.vars[n].use_ops)
        return out

    def topological_order(self) -> List[OpNode]:
        """Kahn topological sort (MIR ``SSAGraph::StmtTopologicalOrder``)."""
        indeg: Dict[int, int] = {}
        by_id = {op.id: op for op in self.ops}
        for op in self.ops:
            indeg[op.id] = sum(
                1
                for n in op.input_names()
                if self.vars[n].def_op is not None
            )
        ready = [op for op in self.ops if indeg[op.id] == 0]
        order: List[OpNode] = []
        while ready:
            op = ready.pop(0)
            order.append(op)
            for c in self.consumers(op):
                indeg[c.id] -= sum(
                    1 for n in c.input_names() if self.vars[n].def_op is op
                )
                if indeg[c.id] == 0 and c not in ready and c not in order:
                    ready.append(c)
        if len(order) != len(self.ops):
            missing = [op for op in self.ops if op not in order]
            raise RuntimeError(f"graph has a cycle; unplaced ops: {missing}")
        return order

    def remove_ops(self, ops: Iterable[OpNode]) -> None:
        dead = {id(o) for o in ops}
        self.ops = [o for o in self.ops if id(o) not in dead]
        self.rebuild_links()

    def remove_unused_vars(self) -> None:
        used = set(self.inputs) | set(self.outputs)
        for op in self.ops:
            used.update(op.input_names())
            used.update(op.output_names())
        for name in list(self.vars):
            if name not in used:
                del self.vars[name]
                self.weights.pop(name, None)

    def replace_var_uses(self, old: str, new: str) -> None:
        """Redirect every consumer (and graph output) of `old` to `new`."""
        for op in self.ops:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [new if n == old else n for n in names]
        self.outputs = [new if n == old else n for n in self.outputs]
        self.rebuild_links()

    # ---- debug -----------------------------------------------------------
    def dump(self) -> str:
        """Readable text dump (``graph_visualize_pass`` analog)."""
        lines = [f"graph {self.name}  inputs={self.inputs} outputs={self.outputs}"]
        for op in self.topological_order():
            ins = {k: v for k, v in op.inputs.items() if v}
            outs = {k: v for k, v in op.outputs.items() if v}
            extras = []
            if op.attrs.get("enable_int8"):
                extras.append("int8")
            if op.attrs.get("fuse_act"):
                extras.append(f"act={op.attrs['fuse_act']}")
            if op.attrs.get("kernel"):
                extras.append(f"k={op.attrs['kernel']}")
            tag = (" [" + ",".join(extras) + "]") if extras else ""
            lines.append(f"  {op.op_type}{tag} {ins} -> {outs}")
        return "\n".join(lines)
