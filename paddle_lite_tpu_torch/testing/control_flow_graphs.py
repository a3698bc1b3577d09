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
  loaded program of each captures, :data:`NODES` the conditional nodes
  that a capture of each makes;
- :func:`int8_loop`: a loop whose block holds an int8 ``fc`` on the GEMM
  kernel (the ``"cuda"`` tag; its plain version on the CPU), its state
  requantized each trip.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.builder import GraphBuilder
from ..core.ir import Graph
from ..core.types import Precision, QuantInfo
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


# CUDA graphs a loaded program of each case captures: one, its control
# flow conditional nodes inside it, no host step
LOADED_GRAPHS = {"gated_loop": 1, "hits_max_iters": 1, "crossed_state": 1, "decode": 1,
                 "cond": 1, "cond_while": 1}

# the conditional nodes that a capture of each case makes, in order, as
# (kind, depth): a while one WHILE node, a conditional_block (a cond) two
# IF nodes, on the flag and on its negation; a node made inside a body is
# one deeper.  The compiled predictor and a loaded program make the same.
NODES = {"gated_loop": [("while", 0)], "hits_max_iters": [("while", 0)],
         "crossed_state": [("while", 0)], "decode": [("while", 0)],
         "cond": [("if", 0), ("if", 0)],
         "cond_while": [("if", 0), ("while", 1), ("if", 0)],
         "int8_loop": [("while", 0)]}

INT8_SCALE = 0.05  # the loop state's per-tensor scale, in and out


def int8_loop(m: int = 64, k: int = 64, trips: int = 4, seed: int = 21) -> Graph:
    """x <- requant(x @ w) for `trips` trips: a while loop whose block holds
    an int8 ``fc`` (per-channel weight scales, int8 out at the state's
    scale) tagged ``"cuda"``, so that on the card its GEMM kernel launches
    inside the loop's body; outputs the step count and x."""
    rng = np.random.default_rng(seed)
    inner, c2, s2 = _step_block("int8_body", float(trips), None)
    x = inner.input("x_in", (m, k), precision=Precision.INT8)
    inner.g.vars[x].quant = QuantInfo.per_tensor(INT8_SCALE)
    w = inner.weight("w", rng.integers(-127, 128, (k, k), dtype=np.int8))
    inner.g.vars[w].quant = QuantInfo.per_channel_scales(
        rng.uniform(0.5e-3, 2e-3, k).astype(np.float32), axis=1)
    y = inner.op("fc", {"Input": [x], "W": [w]},
                 attrs={"in_num_col_dims": 1, "enable_int8": True, "kernel": "cuda",
                        "out_scale": INT8_SCALE},
                 shape_args=[x, w], out_precisions=[Precision.INT8])[0]
    inner.g.vars[y].quant = QuantInfo.per_tensor(INT8_SCALE)
    inner.mark_output(c2, s2, y)
    b = GraphBuilder("int8_outer")
    xo = b.input("x", (m, k), precision=Precision.INT8)
    b.g.vars[xo].quant = QuantInfo.per_tensor(INT8_SCALE)
    cond, step = _true(b), _zero(b)
    outs = b.op("while", {"X": [cond, step, xo]},
                attrs={"block": inner.build(), "cond_index": 0, "max_iters": 100},
                shape_args=[cond, step, xo], out_slots=("Out",),
                out_precisions=[Precision.BOOL, Precision.FP32, Precision.INT8])
    b.mark_output(outs[1], outs[2])
    return b.build()


def int8_feed(m: int = 64, k: int = 64, seed: int = 22) -> dict:
    return {"x": np.random.default_rng(seed).integers(-127, 128, (m, k), dtype=np.int8)}
