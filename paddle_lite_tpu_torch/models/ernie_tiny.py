"""ERNIE-tiny — BASELINE config #5: a quantized transformer encoder.

Port of ``paddle_lite_tpu/models/ernie_tiny.py``: the same graph, op for
op, and the same seeded weights, drawn in the same order from the
builder's generator.  Token and segment ids (int32) look up their
embeddings, a position embedding is added from a weight, then ``n_layers``
post-norm encoder layers (self-attention of ``n_heads`` heads, an FFN
whose activation is ``hidden_act``) → the first token → a tanh pooler
``fc`` → the classifier ``fc`` → softmax.  The GEMMs are ``mul`` / ``fc``
ops (int8 after quantization); the attention matmuls, softmax and
layer_norm stay float unless the config quantizes act×act matmuls.

ERNIE-tiny's published shape: 3 layers, hidden 1024, 16 heads, FFN 4096
with ReLU, vocabulary 50,006.  The builder's defaults keep the JAX
package's graph: vocabulary 18,000 and GELU (``hidden_act="relu"`` is the
published FFN).  The model has no attention mask: every position attends
to every other, padding included.
"""

from __future__ import annotations

import numpy as np

from ..core.builder import GraphBuilder
from ..core.ir import Graph
from ..core.types import Precision

HIDDEN_ACTS = ("gelu", "relu")  # the FFN's activation


def _layer_norm(b: GraphBuilder, x: str, name: str) -> str:
    d = b.g.vars[x].shape[-1]
    scale = b.weight(f"{name}.scale", np.ones((d,), np.float32))
    bias = b.weight(f"{name}.bias", np.zeros((d,), np.float32))
    return b.op("layer_norm", {"X": [x], "Scale": [scale], "Bias": [bias]},
                attrs={"begin_norm_axis": len(b.g.vars[x].shape) - 1,
                       "epsilon": 1e-12},
                shape_args=[x], out_slots=("Y",), out_name=name)[0]


def _dense(b: GraphBuilder, x: str, out_dim: int, name: str,
           act: str = None) -> str:
    """3-D dense via mul (B,T,D)x(D,O): the quantizable transformer GEMM."""
    d = b.g.vars[x].shape[-1]
    w = b.rand_weight(f"{name}.w", (d, out_dim), scale=np.sqrt(1.0 / d))
    y = b.op("mul", {"X": [x], "Y": [w]},
             attrs={"x_num_col_dims": 2, "y_num_col_dims": 1},
             shape_args=[x, w], out_name=name)[0]
    bias = b.weight(f"{name}.b", np.zeros((out_dim,), np.float32))
    y = b.eltwise(y, bias, "add")
    if act:
        y = b.act(y, act)
    return y


def _attention(b: GraphBuilder, x: str, n_heads: int, name: str) -> str:
    bs, t, d = b.g.vars[x].shape
    hd = d // n_heads
    q = _dense(b, x, d, f"{name}.q")
    k = _dense(b, x, d, f"{name}.k")
    v = _dense(b, x, d, f"{name}.v")

    def split_heads(z):
        z = b.reshape(z, (bs, t, n_heads, hd))
        return b.transpose(z, (0, 2, 1, 3))  # (B, nh, T, hd)

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    scores = b.op("matmul", {"X": [qh], "Y": [kh]},
                  attrs={"transpose_Y": True, "alpha": 1.0 / np.sqrt(hd)},
                  shape_args=[qh, kh], out_name=f"{name}.qk")[0]
    probs = b.softmax(scores, axis=-1)
    ctxv = b.op("matmul", {"X": [probs], "Y": [vh]},
                shape_args=[probs, vh], out_name=f"{name}.pv")[0]
    ctxv = b.transpose(ctxv, (0, 2, 1, 3))
    ctxv = b.reshape(ctxv, (bs, t, d))
    return _dense(b, ctxv, d, f"{name}.out")


def build(batch: int = 1, seq_len: int = 128, vocab_size: int = 18000,
          hidden: int = 1024, n_layers: int = 3, n_heads: int = 16,
          ffn_dim: int = 4096, num_classes: int = 2, seed: int = 0,
          type_vocab: int = 4, hidden_act: str = "gelu") -> Graph:
    if hidden_act not in HIDDEN_ACTS:
        raise ValueError(f"hidden_act must be one of {HIDDEN_ACTS}, got {hidden_act!r}")
    b = GraphBuilder("ernie_tiny", seed=seed)

    tok = b.input("token_ids", (batch, seq_len), precision=Precision.INT32)
    seg = b.input("segment_ids", (batch, seq_len), precision=Precision.INT32)

    word_emb = b.rand_weight("word_emb", (vocab_size, hidden), scale=0.02)
    pos_emb = b.rand_weight("pos_emb", (seq_len, hidden), scale=0.02)
    seg_emb = b.rand_weight("seg_emb", (type_vocab, hidden), scale=0.02)

    we = b.op("lookup_table", {"W": [word_emb], "Ids": [tok]},
              shape_args=[word_emb, tok], out_name="we")[0]
    se = b.op("lookup_table", {"W": [seg_emb], "Ids": [seg]},
              shape_args=[seg_emb, seg], out_name="se")[0]
    x = b.eltwise(we, se, "add")
    x = b.eltwise(x, pos_emb, "add")  # broadcast (T, H) over the batch
    x = _layer_norm(b, x, "emb_ln")

    for i in range(n_layers):
        attn = _attention(b, x, n_heads, f"l{i}.attn")
        x = b.eltwise(x, attn, "add")
        x = _layer_norm(b, x, f"l{i}.ln1")
        ff = _dense(b, x, ffn_dim, f"l{i}.ffn1", act=hidden_act)
        ff = _dense(b, ff, hidden, f"l{i}.ffn2")
        x = b.eltwise(x, ff, "add")
        x = _layer_norm(b, x, f"l{i}.ln2")

    # pooler: the first token -> tanh fc -> classifier
    cls = b.op("slice", {"X": [x]},
               attrs={"axes": [1], "starts": [0], "ends": [1],
                      "decrease_axis": [1]},
               shape_args=[x], out_name="cls")[0]
    pooled = b.fc(cls, hidden, name="pooler")
    pooled = b.act(pooled, "tanh")
    logits = b.fc(pooled, num_classes, name="cls_head")
    probs = b.softmax(logits)
    b.mark_output(probs)
    return b.build()
