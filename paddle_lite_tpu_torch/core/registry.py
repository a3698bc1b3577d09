"""Operator registry — analog of ``lite/core/op_registry.{h,cc}``.

Port of ``paddle_lite_tpu/core/registry.py``.  An op registers an
``infer_shape(attrs, in_shapes) -> out_shapes`` function and one or more
implementations keyed by a kernel tag:

- ``"torch"`` — plain PyTorch ops; the default, and the CPU path (the part
  ``"xla"`` plays in the JAX package);
- ``"cuda"`` — a hand-written CUDA kernel (the part ``"pallas"`` plays).

The kernel-pick pass stamps the chosen tag on the op node.  One change from
the reference: ``OpDef.impl_for`` there (``core/registry.py:39-45``) falls
back to ``"xla"`` when the stamped tag has no impl, which silently runs
another kernel than the one picked.  Here a stamped tag without an impl
raises.

Implementations are functions ``impl(ctx, op, inputs: dict[str, list
[Tensor]]) -> dict[str, list[Tensor]]`` run eagerly by the executor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

ShapeList = List[Tuple[int, ...]]
InferShapeFn = Callable[..., Any]
ImplFn = Callable[..., Dict[str, list]]

DEFAULT_KERNEL = "torch"


@dataclasses.dataclass
class OpDef:
    name: str
    infer_shape: Optional[InferShapeFn]
    impls: Dict[str, ImplFn] = dataclasses.field(default_factory=dict)
    # slots documented for importers/tools (not enforced)
    input_slots: Sequence[str] = ()
    output_slots: Sequence[str] = ("Out",)

    def impl_for(self, kernel: Optional[str]) -> ImplFn:
        tag = kernel or DEFAULT_KERNEL
        if tag not in self.impls:
            raise KeyError(
                f"op {self.name!r} has no {tag!r} implementation; "
                f"registered: {sorted(self.impls)}"
            )
        return self.impls[tag]


class OpRegistry:
    """Global op table (``KernelRegistry``/``OpLiteRegistry`` analog)."""

    def __init__(self) -> None:
        self._ops: Dict[str, OpDef] = {}

    def register(
        self,
        name: str,
        infer_shape: Optional[InferShapeFn] = None,
        input_slots: Sequence[str] = (),
        output_slots: Sequence[str] = ("Out",),
    ) -> OpDef:
        if name not in self._ops:
            self._ops[name] = OpDef(
                name=name,
                infer_shape=infer_shape,
                input_slots=input_slots,
                output_slots=output_slots,
            )
        elif infer_shape is not None:
            self._ops[name].infer_shape = infer_shape
        return self._ops[name]

    def kernel(self, op_name: str, kernel: str = DEFAULT_KERNEL):
        """Decorator: register an implementation for `op_name` under `kernel`."""

        def deco(fn: ImplFn) -> ImplFn:
            self.register(op_name).impls[kernel] = fn
            return fn

        return deco

    def shape_fn(self, op_name: str):
        """Decorator: register the InferShape function for `op_name`."""

        def deco(fn: InferShapeFn) -> InferShapeFn:
            self.register(op_name, infer_shape=fn)
            return fn

        return deco

    def get(self, name: str) -> OpDef:
        if name not in self._ops:
            raise KeyError(
                f"op {name!r} is not registered; known: {sorted(self._ops)}"
            )
        return self._ops[name]

    def __contains__(self, name: str) -> bool:
        return name in self._ops

    def names(self) -> List[str]:
        return sorted(self._ops)


OPS = OpRegistry()
