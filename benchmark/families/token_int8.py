"""Transformer encoders over token ids, quantized to int8 by the program's PTQ.

What the harness needs of a kind of model, for every configuration whose
file names ``"family": "token_int8"``:

- :func:`make`: the weights and the calibration sequences, from the run's
  generator on the card.  Embeddings are N(0, ``initializer_range``²),
  dense weights N(0, 1/fan_in) (as the program's own builder draws them, so
  that attention is not uniform), biases ``0.01 z``, layer-norm scales
  ``1 + 0.1 z`` and shifts ``0.05 z``; then the classifier is scaled so
  that the float model's logits over the calibration sequences have the
  standard deviation ``cfg["init"]["logit_std"]``.
- :func:`inputs`: ``n`` sequence pairs as one int32 tensor (n, 2, T) of
  token ids, then segment ids: [CLS], a first sentence, [SEP], a second
  sentence, [SEP], no padding.  The split is drawn a sequence from the seed
  (each sentence at least ``cfg["inputs"]["min_sentence"]`` tokens); word
  ids are Zipf-distributed (``cfg["inputs"]["zipf_exponent"]``) over the
  ordinary ids, from ``cfg["inputs"]["first_word_id"]`` up, the lowest the
  most frequent; segment ids are 0 through the first [SEP], then 1.
- :func:`build`, :func:`feed`, :func:`answer`: the program's predictor at a
  batch (its model-building function given the configuration's sizes by
  ``cfg["program"]["args"]``), calibrated and quantized by
  ``create_predictor``; its feed (the ids split into contiguous token and
  segment tensors); its answer rows (the softmax output).
- :class:`Reference`: the plain reference (``reference/<cfg["reference"]>.py``
  over ``reference/tref.py``), int8 as the configuration states, or int4 for
  the control.
- :func:`compare` and :func:`model`: ``cnn_int8``'s; ``compare`` over the
  classifier's softmax rows (``logit_rel_err``, ``own_vs_other``).
- :func:`install`: the weights into the program's unoptimized graph, by
  name.

The reference side imports nothing of the program; :func:`build` and
:func:`install` are the only functions that touch it.
"""

from __future__ import annotations

import importlib
import math
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..reference import tref
from .cnn_int8 import compare, model  # noqa: F401  (the family's compare and model)


def _draw(cfg: dict, spec: List[Tuple[str, tuple, str]], gen: torch.Generator,
          device: torch.device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor for every (name, shape, kind) of `spec`, in
    one normal draw."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, kind), v in zip(spec, torch.split(z, sizes)):
        if kind == "emb":
            v = v * float(cfg["initializer_range"])
        elif kind == "fc":
            v = v * math.sqrt(1.0 / shape[0])
        elif kind == "bias":
            v = 0.01 * v
        elif kind == "ln_gamma":
            v = 1.0 + 0.1 * v
        elif kind == "ln_beta":
            v = 0.05 * v
        else:
            raise ValueError(f"unknown weight kind {kind!r}")
        out[name] = v.reshape(shape)
    return out


def inputs(cfg: dict, gen: torch.Generator, n: int, device: torch.device) -> torch.Tensor:
    """`n` int32 id rows (n, 2, T) made from `gen` (see the module's text)."""
    t, spec = int(cfg["seq_len"]), cfg["inputs"]
    first, lo = int(spec["first_word_id"]), int(spec["min_sentence"])
    ranks = torch.arange(1, int(cfg["vocab_size"]) - first + 1, device=device,
                         dtype=torch.float64)
    cdf = torch.cumsum(ranks.pow(-float(spec["zipf_exponent"])), 0)
    u = torch.rand((n, t), generator=gen, device=device, dtype=torch.float64)
    tok = first + torch.searchsorted(cdf / cdf[-1], u).clamp_max(len(ranks) - 1)
    # the first sentence's length; its [SEP] at 1 + length, the last at T - 1
    length = torch.randint(lo, t - 2 - lo, (n, 1), generator=gen, device=device)
    pos = torch.arange(t, device=device).expand(n, t)
    ids = cfg["special_ids"]
    tok[:, 0] = int(ids["cls"])
    tok[(pos == length + 1) | (pos == t - 1)] = int(ids["sep"])
    seg = (pos > length + 1).to(tok.dtype)
    return torch.stack([tok, seg], dim=1).to(torch.int32)


def _float_logits(m, cfg: dict, p: dict, x: torch.Tensor, block: int) -> torch.Tensor:
    f32 = tref.Float32()
    return torch.cat([f32.run(lambda be, q, xb: m.forward(be, cfg, q, xb), p, x[i:i + block])
                      for i in range(0, len(x), block)])


def make(cfg: dict, gen: torch.Generator, device: torch.device) -> SimpleNamespace:
    """The weights (host float32 arrays, by the reference's names) and the
    calibration sequences (a host int32 array), drawn in that order from
    `gen`."""
    m = model(cfg)
    spec = m.params(cfg)
    raw = _draw(cfg, spec, gen, device)
    calib = inputs(cfg, gen, int(cfg["calib_sequences"]), device)
    logits = _float_logits(m, cfg, m.fold(cfg, raw), calib, int(cfg["reference_block"]))
    factor = float(cfg["init"]["logit_std"]) / float(logits.std())
    raw["cls_head.w"].mul_(factor)
    raw["cls_head.b"].mul_(factor)
    host = {name: v.cpu().numpy() for name, v in raw.items()}
    return SimpleNamespace(spec=spec, raw=host, calib=calib.cpu().numpy(),
                           info={"classifier_scale": factor})


def install(graph, spec: List[Tuple[str, tuple, str]], raw: Dict[str, np.ndarray]) -> None:
    """Put `raw` into the unoptimized `graph` by name; a weight the graph
    and the reference do not both have, or a shape that differs, raises."""
    names = {n for n, v in graph.vars.items() if v.is_weight}
    ref = {n for n, _, _ in spec}
    if names != ref:
        raise ValueError(f"weights only the graph has: {sorted(names - ref)}; "
                         f"only the reference: {sorted(ref - names)}")
    for n, shape, _ in spec:
        if tuple(graph.vars[n].shape) != tuple(shape):
            raise ValueError(f"{n} has shape {graph.vars[n].shape}, the reference's {shape}")
        graph.weights[n] = np.array(raw[n], copy=True)


def build(cfg: dict, made: SimpleNamespace, batch: int, device: torch.device):
    """The program's predictor at `batch`: the graph its model-building
    function makes, with `made`'s weights, calibrated on `made`'s sequences
    `batch` at a time and quantized by ``create_predictor``."""
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor

    mod, fn = cfg["program"]["build"].split(":")
    sizes = {arg: cfg[key] for arg, key in cfg["program"]["args"].items()}
    graph = getattr(importlib.import_module(mod), fn)(
        batch=batch, **sizes, **cfg["program"]["kwargs"])
    install(graph, made.spec, made.raw)
    calib = made.calib
    if len(calib) % batch:
        raise ValueError(f"{len(calib)} calibration sequences do not split into "
                         f"batches of {batch}")
    return create_predictor(graph, quant=QuantConfig(**cfg["program"]["quant"]),
                            calib_batches=[feed_of(graph, calib[i:i + batch])
                                           for i in range(0, len(calib), batch)],
                            device=device)


def feed_of(graph, x) -> dict:
    """The graph's inputs (token ids, segment ids) from id rows (n, 2, T),
    each contiguous."""
    if isinstance(x, np.ndarray):
        return {name: np.ascontiguousarray(x[:, i]) for i, name in enumerate(graph.inputs)}
    return {name: x[:, i].contiguous() for i, name in enumerate(graph.inputs)}


def feed(pred, x) -> dict:
    return feed_of(pred.graph, x)


def answer(pred, outputs: dict):
    return outputs[pred.graph.outputs[0]]


class Reference:
    """The reference prepared from `made` (abs-maxes calibrated on its
    sequences): ``ref(x)`` gives float64 softmax rows at int8,
    ``ref(x, low=True)`` at int4, the control."""

    def __init__(self, cfg: dict, made: SimpleNamespace, device: torch.device):
        raw = {k: torch.from_numpy(v).to(device) for k, v in made.raw.items()}
        block = int(cfg["reference_block"])
        calib = [torch.from_numpy(made.calib[i:i + block]).to(device)
                 for i in range(0, len(made.calib), block)]
        self.ref = tref.Reference(model(cfg), cfg, raw, calib)

    def __call__(self, x: torch.Tensor, low: bool = False) -> torch.Tensor:
        return self.ref(x, 4 if low else 8)
