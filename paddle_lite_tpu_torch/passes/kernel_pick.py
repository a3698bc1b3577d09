"""Kernel-pick pass — port of ``paddle_lite_tpu/passes/kernel_pick.py``
(analog of ``lite/core/mir/static_kernel_pick_pass.cc``).

Stamps ``kernel="cuda"`` on every int8 op a hand-written kernel takes and
on every ``multiclass_nms*`` op (``ops/kernels/select.py``); every other op
keeps the default ``"torch"`` impl.
"""

from __future__ import annotations

from ..core.ir import Graph
from ..core.pass_manager import register_pass


@register_pass("kernel_pick")
def kernel_pick(graph: Graph) -> None:
    from ..ops.kernels import select

    for op in graph.ops:
        choice = select.choose_kernel(graph, op)
        if choice:
            op.attrs["kernel"] = choice
