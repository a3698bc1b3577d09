"""Program dumps — graph observability.

Port of ``paddle_lite_tpu/tools/dump.py``, the analog of the reference's
``graph_visualize_pass`` (dot dump) and ``argument_type_display_pass``:
:func:`dump_graph` (the typed op graph as text) and :func:`dump_dot`
(Graphviz), each the reference's string for the same graph (the text dump
names kernel tags in the port's vocabulary, ``"torch"`` / ``"cuda"``).
:func:`dump_exported` prints the ``torch.export`` program of the graph
(``formats/aot.py``), the counterpart of ``dump_jaxpr``: the traced ops,
the kernels among them as ``plt::`` custom ops.  ``dump_hlo`` has no
analog: PyTorch runs the ops eagerly (or replays them as a CUDA graph), and
no compiler's optimized program stands between the graph and the card.
"""

from __future__ import annotations

from ..core.device import DeviceLike
from ..core.ir import Graph


def dump_graph(graph: Graph) -> str:
    """Typed op-graph dump (graph_visualize + argument_type_display)."""
    return graph.dump()


def dump_dot(graph: Graph) -> str:
    """Graphviz dot of the op graph (graph_visualize_pass analog)."""
    lines = ["digraph G {", "  rankdir=TB;", "  node [shape=box];"]
    for op in graph.ops:
        label = op.op_type
        extras = []
        if op.attrs.get("enable_int8"):
            extras.append("int8")
        if op.attrs.get("fuse_act"):
            extras.append(op.attrs["fuse_act"])
        if extras:
            label += "\\n" + ",".join(extras)
        color = "lightblue" if op.attrs.get("enable_int8") else "white"
        lines.append(f'  op{op.id} [label="{label}", style=filled, '
                     f'fillcolor={color}];')
    for op in graph.ops:
        for n in op.input_names():
            src = graph.vars[n].def_op
            if src is not None:
                prec = graph.vars[n].precision.value
                lines.append(f'  op{src.id} -> op{op.id} [label="{prec}"];')
    lines.append("}")
    return "\n".join(lines)


def dump_exported(graph: Graph, *, device: DeviceLike = None) -> str:
    """The exported program's graph (``torch.export``), as text."""
    from ..formats.aot import export_program

    ep, _ = export_program(graph, device=device)
    return str(ep.graph_module.graph)
