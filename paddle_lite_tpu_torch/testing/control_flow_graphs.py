"""Small graphs with ``while`` and ``conditional_block``, each with a
seeded feed: the control-flow cases that the CPU tests run through the
compiled predictor and the loaded exported program against the eager loop
(and the reference), and that ``chip_smoke.py`` phase 14d captures on the
card.

- :func:`cond_graph`: x -> scale -> conditional_block -> tanh, the block
  run when the input flag holds; its block an affine map, or a block
  holding a ``while`` (:func:`block_with_while`);
- :func:`swap_graph`: a loop whose block swaps two state vars (each
  output named as the other's input) for three trips;
- :func:`counting_loop`: x <- x·0.5 + 0.25 while a step counter stays
  below a limit, at most ``max_iters`` trips; its start condition a
  constant or the input ``go`` (False runs no trip);
- :func:`cases`: every case above with its feeds and trip counts, and
  the beam-search decode loop (``models/beam_decode``) at b2 / beam 2 /
  hidden 8 / vocab 50 / 5 steps; :data:`LOADED_GRAPHS` the CUDA graphs a
  loaded program of each captures.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.builder import GraphBuilder
from ..core.ir import Graph
from ..core.types import Precision
from ..models import beam_decode
from .op_cases import _affine_block

DECODE = dict(batch=2, beam=2, hidden=8)


def _true(b: GraphBuilder) -> str:
    return b.op("fill_constant", {}, attrs={"shape": [1], "value": True, "dtype": "bool"},
                shape_args=[], out_precisions=[Precision.BOOL])[0]


def _zero(b: GraphBuilder) -> str:
    return b.op("fill_constant", {}, attrs={"shape": [1], "value": 0.0}, shape_args=[])[0]


def _step_block(name: str, limit: float, shape) -> GraphBuilder:
    """A block over (condition, step, x): step + 1, the condition step + 1
    < `limit`; x left to the caller."""
    inner = GraphBuilder(name)
    inner.input("c_in", (1,), precision=Precision.BOOL)
    s = inner.input("s_in", (1,))
    if shape is not None:
        inner.input("x_in", shape)
    inner.weight("limit", np.full((1,), limit, np.float32))
    s2 = inner.op("increment", {"X": [s]}, attrs={"step": 1.0})[0]
    c2 = inner.op("less_than", {"X": [s2], "Y": ["limit"]}, shape_args=[s2, "limit"],
                  out_precisions=[Precision.BOOL])[0]
    return inner, c2, s2


def block_with_while(shape) -> Graph:
    """A block whose body holds a while loop (five trips of x <- x·0.5 +
    0.25)."""
    bb = GraphBuilder("with_loop")
    x = bb.input("x_in", shape)
    cond, step = _true(bb), _zero(bb)
    inner, c2, s2 = _step_block("inner", 5.0, shape)
    x2 = inner.op("scale", {"X": ["x_in"]}, attrs={"scale": 0.5, "bias": 0.25})[0]
    inner.mark_output(c2, s2, x2)
    outs = bb.op("while", {"X": [cond, step, x]},
                 attrs={"block": inner.build(), "cond_index": 0, "max_iters": 100},
                 shape_args=[cond, step, x], out_slots=("Out",),
                 out_precisions=[Precision.BOOL, Precision.FP32, Precision.FP32])
    bb.mark_output(outs[2])
    return bb.build()


def cond_graph(n: int = 3, c: int = 4, nested_while: bool = False) -> Graph:
    """x -> scale -> conditional_block(affine) -> tanh, the block run when
    the input flag holds; optionally a while loop inside the block."""
    b = GraphBuilder("cond_outer")
    x = b.input("x", (n, c))
    flag = b.input("flag", (1,), precision=Precision.BOOL)
    y = b.op("scale", {"X": [x]}, attrs={"scale": 2.0, "bias": 0.0})[0]
    block = block_with_while((n, c)) if nested_while else _affine_block((n, c))
    y = b.op("conditional_block", {"Cond": [flag], "Input": [y]}, attrs={"block": block},
             shape_args=[flag, y])[0]
    b.mark_output(b.act(y, "tanh"))
    return b.build()


def swap_graph() -> Graph:
    """A while loop whose block swaps its two state vars (outputs named as
    the other's input) and counts three trips."""
    inner, c2, s2 = _step_block("swap", 3.0, None)
    inner.input("a_in", (2, 3))
    inner.input("b_in", (2, 3))
    inner.mark_output(c2, s2, "b_in", "a_in")
    b = GraphBuilder("swap_outer")
    a = b.input("a", (2, 3))
    bx = b.input("b", (2, 3))
    cond, step = _true(b), _zero(b)
    outs = b.op("while", {"X": [cond, step, a, bx]},
                attrs={"block": inner.build(), "cond_index": 0, "max_iters": 10},
                shape_args=[cond, step, a, bx], out_slots=("Out",),
                out_precisions=[Precision.BOOL, Precision.FP32, Precision.FP32,
                                Precision.FP32])
    b.mark_output(outs[2], outs[3])
    return b.build()


def counting_loop(limit: float, max_iters: int, gated: bool = False) -> Graph:
    """x <- x·0.5 + 0.25 while a step counter stays below `limit`, at most
    `max_iters` trips; outputs the step count and x.  `gated`: the start
    condition is the input ``go``, else true."""
    inner, c2, s2 = _step_block("count", limit, (2, 3))
    x2 = inner.op("scale", {"X": ["x_in"]}, attrs={"scale": 0.5, "bias": 0.25})[0]
    inner.mark_output(c2, s2, x2)
    b = GraphBuilder("outer")
    x = b.input("x", (2, 3))
    c = b.input("go", (1,), precision=Precision.BOOL) if gated else _true(b)
    s0 = _zero(b)
    outs = b.op("while", {"X": [c, s0, x]},
                attrs={"block": inner.build(), "cond_index": 0, "max_iters": max_iters},
                shape_args=[c, s0, x], out_slots=("Out",),
                out_precisions=[Precision.BOOL, Precision.FP32, Precision.FP32])
    b.mark_output(outs[1], outs[2])
    return b.build()


def cases() -> Dict[str, Tuple[Graph, List[dict], List[Optional[int]]]]:
    """name -> (graph, feeds, the trips of its top-level loop on each feed,
    None without one): each case's feeds run through one compiled
    predictor and one loaded program, one after the other."""
    rng = np.random.default_rng(20)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    x23 = np.arange(6, dtype=np.float32).reshape(2, 3)
    flags = [{"x": x, "flag": np.array([f])} for f in (True, False)]
    return {
        "gated_loop": (counting_loop(5.0, 100, gated=True),
                       [{"x": x23, "go": np.array([go])} for go in (True, False)], [5, 0]),
        "hits_max_iters": (counting_loop(5.0, 3), [{"x": x23}], [3]),
        "crossed_state": (swap_graph(), [{k: rng.normal(size=(2, 3)).astype(np.float32)
                                          for k in "ab"}], [3]),
        "decode": (beam_decode.build(vocab=50, steps=5, **DECODE),
                   [beam_decode.feed(**DECODE, seed=s) for s in (1, 2)], [5, 5]),
        "cond": (cond_graph(), flags, [None, None]),
        "cond_while": (cond_graph(nested_while=True), flags, [None, None]),
    }


# CUDA graphs a loaded program of each case captures: a graph either side
# of each control-flow op (a cut), a loop's trip and each branch one of
# their own, a cut inside a branch two more
LOADED_GRAPHS = {"gated_loop": 3, "hits_max_iters": 3, "crossed_state": 3, "decode": 3,
                 "cond": 4, "cond_while": 6}
