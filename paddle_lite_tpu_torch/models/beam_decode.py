"""A beam-search decode loop under ``while`` — how Paddle-Lite runs seq2seq
decoding: the decoder step is a ``while`` block that the runtime repeats
until its condition fails.

The graph: the loop state (a condition, a step counter, the last ids, the
beam scores, the decoder state (B·beam, hidden) and the vocabulary
projection (hidden, vocab)) enters one ``while`` op.  Each trip of its
block runs

1. ``fc``: logits = state · W_vocab, then ``softmax`` over the vocabulary;
2. ``beam_search``: the best ``beam`` continuations of each batch row
   (ids, accumulated log-probability scores, parent beams);
3. ``gather`` by parent: each new beam takes its parent's state rows
   (the parent index offset by its batch row's first beam);
4. the state update tanh(parent state + id / vocab · u);
5. ``increment`` of the step counter and ``less_than`` against ``steps``,
   the next trip's condition.

The vocabulary projection is a weight of the outer graph carried as loop
state, not a weight of the block: the shared artifact format stores a
block's weights inline as JSON, which suits the block's few small
vectors but not a (hidden, vocab) matrix.  Weights are random, drawn from
``seed``.  Outputs: the final ids, scores and step count.
"""

from __future__ import annotations

import numpy as np

from ..core.builder import GraphBuilder
from ..core.ir import Graph
from ..core.types import Precision

END_ID = 1
BOS_ID = 0


def _block(batch: int, beam: int, hidden: int, vocab: int, steps: int,
           rng: np.random.Generator) -> Graph:
    bb = GraphBuilder("beam_step")
    cond = bb.input("cond_in", (1,), precision=Precision.BOOL)
    step = bb.input("step_in", (1,))
    ids = bb.input("ids_in", (batch, beam), precision=Precision.INT32)
    scores = bb.input("scores_in", (batch, beam))
    h = bb.input("h_in", (batch * beam, hidden))
    w = bb.input("w_vocab_in", (hidden, vocab))
    del cond
    bb.weight("limit", np.full((1,), float(steps), np.float32))
    bb.weight("row_base", (np.arange(batch, dtype=np.int32)[:, None] * beam
                           + np.zeros((1, beam), np.int32)))
    bb.weight("u", rng.normal(0.0, 1.0, (hidden,)).astype(np.float32))

    logits = bb.op("fc", {"Input": [h], "W": [w]}, attrs={"in_num_col_dims": 1},
                   shape_args=[h, w], out_name="logits")[0]
    probs = bb.reshape(bb.softmax(logits), (batch, beam, vocab))
    sel_ids, sel_scores, parent = bb.op(
        "beam_search", {"pre_ids": [ids], "pre_scores": [scores], "scores": [probs]},
        attrs={"end_id": END_ID}, shape_args=[ids, scores, probs],
        out_slots=("selected_ids", "selected_scores", "parent_idx"),
        out_precisions=[Precision.INT32, Precision.FP32, Precision.INT32])
    rows = bb.op("elementwise_add", {"X": [parent], "Y": ["row_base"]}, attrs={"axis": -1},
                 shape_args=[parent, "row_base"], out_precisions=[Precision.INT32])[0]
    rows = bb.op("reshape", {"X": [rows]}, attrs={"shape": [batch * beam]}, shape_args=[rows],
                 out_precisions=[Precision.INT32])[0]
    h_par = bb.op("gather", {"X": [h], "Index": [rows]}, shape_args=[h, rows])[0]
    idf = bb.op("cast", {"X": [sel_ids]}, attrs={"out_dtype": "float32"},
                shape_args=[sel_ids])[0]
    idf = bb.op("scale", {"X": [bb.reshape(idf, (batch * beam, 1))]},
                attrs={"scale": 1.0 / vocab, "bias": 0.0})[0]
    h_new = bb.act(bb.eltwise(h_par, bb.eltwise(idf, "u", "mul"), "add"), "tanh")
    step_new = bb.op("increment", {"X": [step]}, attrs={"step": 1.0})[0]
    cond_new = bb.op("less_than", {"X": [step_new], "Y": ["limit"]},
                     shape_args=[step_new, "limit"], out_precisions=[Precision.BOOL])[0]
    bb.mark_output(cond_new, step_new, sel_ids, sel_scores, h_new, w)
    return bb.build()


def build(batch: int = 32, beam: int = 4, hidden: int = 1024, vocab: int = 18000,
          steps: int = 32, seed: int = 0) -> Graph:
    """The decode loop; inputs ``h0`` (B·beam, hidden) float32, ``ids0``
    (B, beam) int32 and ``scores0`` (B, beam) float32 (:func:`feed`)."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder("beam_decode", seed=seed)
    h0 = b.input("h0", (batch * beam, hidden))
    ids0 = b.input("ids0", (batch, beam), precision=Precision.INT32)
    scores0 = b.input("scores0", (batch, beam))
    w = b.weight("w_vocab", rng.normal(0.0, 1.0 / np.sqrt(hidden),
                                       (hidden, vocab)).astype(np.float32))
    cond = b.op("fill_constant", {}, attrs={"shape": [1], "value": True, "dtype": "bool"},
                shape_args=[], out_precisions=[Precision.BOOL])[0]
    step = b.op("fill_constant", {}, attrs={"shape": [1], "value": 0.0, "dtype": "float32"},
                shape_args=[])[0]
    state = [cond, step, ids0, scores0, h0, w]
    block = _block(batch, beam, hidden, vocab, steps, rng)
    outs = b.op("while", {"X": state}, attrs={"block": block, "cond_index": 0,
                                             "max_iters": 4 * steps},
                shape_args=state, out_slots=("Out",),
                out_precisions=[Precision.BOOL, Precision.FP32, Precision.INT32,
                                Precision.FP32, Precision.FP32, Precision.FP32],
                out_name="state")
    b.mark_output(outs[2], outs[3], outs[1])
    return b.build()


def feed(batch: int = 32, beam: int = 4, hidden: int = 1024, seed: int = 1) -> dict:
    """A start state: one live beam a batch row (the others at -1e9), BOS
    ids, a random decoder state."""
    rng = np.random.default_rng(seed)
    scores = np.full((batch, beam), -1e9, np.float32)
    scores[:, 0] = 0.0
    return {"h0": rng.normal(0.0, 1.0, (batch * beam, hidden)).astype(np.float32),
            "ids0": np.full((batch, beam), BOS_ID, np.int32), "scores0": scores}
