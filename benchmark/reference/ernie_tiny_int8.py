"""ERNIE-tiny (PaddlePaddle/ERNIE, ``ernie_tiny_config.json``), plain PyTorch.

A post-norm transformer encoder at the sizes of
``configs/ernie_tiny_int8.json``: word, position and segment embeddings
summed, then a layer norm; in each of ``num_hidden_layers`` layers
self-attention of ``num_attention_heads`` heads (Q, K and V from one
projection, softmax of ``Q·Kᵀ / sqrt(d)``, ``P·V``, the output projection),
a residual add and a layer norm, the FFN (``intermediate_size`` wide,
``hidden_act``) and a residual add and a layer norm; then the first
position's state through a tanh pooler and the classifier, over a batch of
ids ``x`` (n, 2, T): token ids, then segment ids.

Departures from the published model, each as the configuration's
``assumed`` states it:

- the position table holds the first ``seq_len`` rows of the published
  ``max_position_embeddings`` (position ids are 0 to T - 1);
- no attention mask: every position is a real token;
- the task-type embedding of ERNIE 2.0's design is left out;
- the layer norms' epsilon is ``layer_norm_eps`` (1e-12), the program's;
- a classifier of ``num_classes`` outputs on the pooler, for the task;
- inference only: no dropout.

Weights are named as the program's graph names them, so the harness
installs them by name.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _layers(cfg: dict):
    return range(int(cfg["num_hidden_layers"]))


def params(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight, in the layers' order."""
    h, f = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
    out = [("word_emb", (int(cfg["vocab_size"]), h), "emb"),
           ("pos_emb", (int(cfg["seq_len"]), h), "emb"),
           ("seg_emb", (int(cfg["sent_type_vocab_size"]), h), "emb")]

    def ln(name):
        out.extend([(f"{name}.scale", (h,), "ln_gamma"), (f"{name}.bias", (h,), "ln_beta")])

    def dense(name, d_in, d_out):
        out.extend([(f"{name}.w", (d_in, d_out), "fc"), (f"{name}.b", (d_out,), "bias")])

    ln("emb_ln")
    for i in _layers(cfg):
        for part in ("q", "k", "v", "out"):
            dense(f"l{i}.attn.{part}", h, h)
        ln(f"l{i}.ln1")
        dense(f"l{i}.ffn1", h, f)
        dense(f"l{i}.ffn2", f, h)
        ln(f"l{i}.ln2")
    dense("pooler", h, h)
    dense("cls_head", h, int(cfg["num_classes"]))
    return out


def fold(cfg: dict, raw: Dict[str, torch.Tensor]) -> dict:
    """(weight, bias) of each dense layer, Q, K and V as one; (scale, bias)
    of each layer norm."""
    p = {k: raw[k] for k in ("word_emb", "pos_emb", "seg_emb")}
    for name, _, kind in params(cfg):
        base = name.rsplit(".", 1)[0]
        if kind == "fc":
            p[base] = (raw[name], raw[f"{base}.b"])
        elif kind == "ln_gamma":
            p[base] = (raw[name], raw[f"{base}.bias"])
    for i in _layers(cfg):
        parts = [p.pop(f"l{i}.attn.{k}") for k in ("q", "k", "v")]
        p[f"l{i}.attn.qkv"] = (torch.cat([w for w, _ in parts], dim=1),
                               torch.cat([b for _, b in parts]))
    return p


def forward(be, cfg: dict, p: dict, x):
    eps, heads = float(cfg["layer_norm_eps"]), int(cfg["num_attention_heads"])
    act = cfg["hidden_act"]
    h = be.embed([p["word_emb"], p["seg_emb"]], [x[:, 0], x[:, 1]], p["pos_emb"])
    h = be.layer_norm(h, p["emb_ln"], eps)
    for i in _layers(cfg):
        a = be.attention(be.fc(be.quant(h), p[f"l{i}.attn.qkv"]), heads)
        h = be.layer_norm(be.add(h, be.fc(a, p[f"l{i}.attn.out"])), p[f"l{i}.ln1"], eps)
        f = be.fc(be.quant(h), p[f"l{i}.ffn1"], act=act, requant=True)
        h = be.layer_norm(be.add(h, be.fc(f, p[f"l{i}.ffn2"])), p[f"l{i}.ln2"], eps)
    pooled = be.fc(be.quant(be.first(h)), p["pooler"], act="tanh", requant=True)
    return be.fc(pooled, p["cls_head"])
