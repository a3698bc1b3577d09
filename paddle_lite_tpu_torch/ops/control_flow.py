"""Control-flow and subgraph ops: ``subgraph``, ``while``,
``conditional_block``, ``split_lod_tensor`` and ``merge_lod_tensor``.

Port of ``paddle_lite_tpu/ops/control_flow.py`` (``:46-159``), the analog
of ``lite/operators/{while,conditional_block,split_lod_tensor,
merge_lod_tensor}_op.cc`` and of the pass-inserted ``subgraph`` op.  The
reference's contract, kept here:

- ``subgraph``: attrs carry a nested :class:`Graph` (``"graph"``); its
  region runs inline, inputs ("Inputs") and outputs ("Outputs") mapped
  positionally onto the nested graph's.
- ``while``: attrs carry a body graph (``"block"``); state var i enters
  the block as ``block.inputs[i]`` and is replaced by
  ``block.outputs[i]`` (cast to the state's dtype), so state in equals
  state out; the loop runs while the state var at ``"cond_index"`` holds
  and fewer than ``"max_iters"`` trips ran.
- ``conditional_block``: runs ``"block"`` on the inputs when the scalar
  ``Cond`` holds, else passes them through.
- ``split_lod_tensor`` / ``merge_lod_tensor``: dense row selects; both
  branches keep every row.

A nested graph's runner and its staged weights are made once per op
(``ctx.const``), not once per trip.  The eager impls of ``while`` and
``conditional_block`` read their condition on the host (``syncs_host``):
``core.executor.compile_graph`` runs them as conditional nodes of its CUDA
graph instead (``core/conditional_nodes``), their blocks' ops inline in
the nodes' bodies.  Under ``torch.export``
(``formats/aot.py``) they trace instead as
``torch._higher_order_ops.while_loop`` and ``torch.cond``, the reference's
``lax.while_loop`` and ``lax.cond``, the same values as the eager forms.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.executor import _runner, block_context
from ..core.registry import OPS


def _nested(ctx, op, key: str, exact: bool = True):
    """(runner, staged weights) of the graph in ``op.attrs[key]``, once per
    op (``executor._runner``'s `exact`), over the op's block context
    (``executor.block_context``, shared with the compiled path)."""
    nested, weights = block_context(ctx, op, key)
    run = ctx.const(op, f"nested_{key}" + ("" if exact else "_traced"),
                    lambda: _runner(op.attrs[key], nested, exact=exact))
    return run, weights


def _run_nested(ctx, op, key: str, env: Dict[str, Any]) -> Dict[str, Any]:
    run, weights = _nested(ctx, op, key)
    return run(weights, {n: env[n] for n in op.attrs[key].inputs})


@OPS.shape_fn("subgraph")
def subgraph_shape(attrs, in_shapes):
    g = attrs["graph"]
    return [g.vars[n].shape for n in g.outputs]


@OPS.kernel("subgraph", "torch")
def subgraph_torch(ctx, op, ins):
    g = op.attrs["graph"]
    out = _run_nested(ctx, op, "graph", dict(zip(g.inputs, ins.get("Inputs", []))))
    return {"Outputs": [out[n] for n in g.outputs]}


def _truth(x: torch.Tensor) -> bool:
    """The first element of `x` as a bool, read on the host."""
    return bool(x.reshape(-1)[0])


@OPS.shape_fn("while")
def while_shape(attrs, in_shapes):
    return list(in_shapes)  # state in == state out


@OPS.kernel("while", "torch", syncs_host=True)
def while_torch(ctx, op, ins):
    block = op.attrs["block"]
    if len(block.outputs) != len(block.inputs):
        raise ValueError("while block must output one var per state input")
    cond_index = int(op.attrs.get("cond_index", 0))
    max_iters = int(op.attrs.get("max_iters", 1000))
    if torch.compiler.is_exporting():
        return _while_exported(ctx, op, ins, cond_index, max_iters)
    state = list(ins["X"])
    trips = 0
    while trips < max_iters and _truth(state[cond_index]):
        out = _run_nested(ctx, op, "block", dict(zip(block.inputs, state)))
        state = [out[n].to(s.dtype) for n, s in zip(block.outputs, state)]
        trips += 1
    return {"Out": state}


@OPS.shape_fn("conditional_block")
def conditional_block_shape(attrs, in_shapes):
    return list(in_shapes[1:])  # [cond, *state] -> state


@OPS.kernel("conditional_block", "torch", syncs_host=True)
def conditional_block_torch(ctx, op, ins):
    block = op.attrs["block"]
    xs = ins["Input"]
    if torch.compiler.is_exporting():
        return _conditional_block_exported(ctx, op, ins)
    if not _truth(ins["Cond"][0]):
        return {"Out": list(xs)}
    out = _run_nested(ctx, op, "block", dict(zip(block.inputs, xs)))
    return {"Out": [out[n] for n in block.outputs]}


def _while_exported(ctx, op, ins, cond_index: int, max_iters: int):
    """``while`` as ``torch._higher_order_ops.while_loop``: the trip count
    is loop state of its own, so ``max_iters`` bounds it on the card."""
    from torch._higher_order_ops import while_loop

    block = op.attrs["block"]
    run, weights = _nested(ctx, op, "block", exact=False)

    def cond(trips, *state):
        return torch.logical_and(trips < max_iters,
                                 state[cond_index].reshape(-1)[0].to(torch.bool))

    def body(trips, *state):
        out = run(weights, dict(zip(block.inputs, state)))
        return (trips + 1,) + tuple(out[n].to(s.dtype).clone()
                                    for n, s in zip(block.outputs, state))

    trips = torch.zeros((), dtype=torch.int64, device=ctx.device)
    return {"Out": list(while_loop(cond, body, (trips,) + tuple(ins["X"]))[1:])}


def _conditional_block_exported(ctx, op, ins):
    """``conditional_block`` as ``torch.cond``."""
    block = op.attrs["block"]
    run, weights = _nested(ctx, op, "block", exact=False)
    xs = tuple(ins["Input"])

    def taken(*xs):
        out = run(weights, dict(zip(block.inputs, xs)))
        return tuple(out[n].clone() for n in block.outputs)

    def passed(*xs):
        return tuple(x.clone() for x in xs)

    flag = ins["Cond"][0].reshape(-1)[0].to(torch.bool)
    return {"Out": list(torch.cond(flag, taken, passed, xs))}


def _row_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (like.ndim - 1)).to(torch.bool)


@OPS.shape_fn("split_lod_tensor")
def split_lod_tensor_shape(attrs, in_shapes):
    return [in_shapes[0], in_shapes[0]]


@OPS.kernel("split_lod_tensor", "torch")
def split_lod_tensor_torch(ctx, op, ins):
    """Rows where ``Mask`` holds to OutTrue, the others to OutFalse; the
    rows of the other branch zeroed."""
    x = ins["X"][0]
    m = _row_mask(ins["Mask"][0], x)
    zero = x.new_zeros(())
    return {"OutTrue": [torch.where(m, x, zero)], "OutFalse": [torch.where(m, zero, x)]}


@OPS.shape_fn("merge_lod_tensor")
def merge_lod_tensor_shape(attrs, in_shapes):
    return [in_shapes[1]]  # [Mask, InTrue, InFalse]


@OPS.kernel("merge_lod_tensor", "torch")
def merge_lod_tensor_torch(ctx, op, ins):
    t, f = ins["InTrue"][0], ins["InFalse"][0]
    return {"Out": [torch.where(_row_mask(ins["Mask"][0], t), t, f)]}
