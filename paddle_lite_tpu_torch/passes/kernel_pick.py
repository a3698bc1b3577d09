"""Kernel-pick pass — port of ``paddle_lite_tpu/passes/kernel_pick.py``
(analog of ``lite/core/mir/static_kernel_pick_pass.cc``).

Stamps ``kernel="cuda"`` on every int8 op a hand-written kernel takes and
on every ``multiclass_nms*`` op (``ops/kernels/select.py``); every other op
keeps the default ``"torch"`` impl.

An int8 op whose activation input is not int8 in the graph keeps the
``"torch"`` impl, which runs it with its int8 weight dequantized: the
kernels take int8 operands only.  A QAT import makes such ops when a
recorded scale sits on an activation that a fusion folds away (the
``qat_ssd_head`` fixture's relu outputs, ``ROADMAP.md`` §3).
"""

from __future__ import annotations

from ..core.ir import Graph
from ..core.pass_manager import register_pass
from ..core.types import Precision

# the activation slot of each op type a kernel takes in int8
ACTIVATION_SLOT = {"conv2d": "Input", "depthwise_conv2d": "Input", "fc": "Input",
                   "mul": "X"}


def int8_activation(graph: Graph, op) -> bool:
    """False for an int8 op whose activation input is not int8."""
    slot = ACTIVATION_SLOT.get(op.op_type)
    if slot is None or not op.attrs.get("enable_int8"):
        return True
    return graph.vars[op.input(slot)].precision == Precision.INT8


@register_pass("kernel_pick")
def kernel_pick(graph: Graph) -> None:
    from ..ops.kernels import select

    for op in graph.ops:
        choice = select.choose_kernel(graph, op)
        if choice and int8_activation(graph, op):
            op.attrs["kernel"] = choice
