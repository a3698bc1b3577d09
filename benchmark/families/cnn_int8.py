"""Image classifiers, NHWC, quantized to int8 by the program's PTQ.

What the harness needs of a kind of model, for every configuration whose
file names ``"family": "cnn_int8"``:

- :func:`make`: the weights and the calibration images, from the run's
  generator on the card.  Weights follow the families the program's own
  model graphs use (He-normal convs, a classifier at ``sqrt(1/in)``); then
  every batch norm is set from the calibration images, layer by layer
  (``qref.DataInit``, ``cfg["init"]``), so that activations keep what tells
  one image from another instead of collapsing to one common vector, and the
  classifier is scaled so that the float model's logits over the calibration
  images have the standard deviation ``cfg["init"]["logit_std"]``.
- :func:`inputs`: ``n`` images: a random field on a coarse grid
  (``cfg["inputs"]["grid"]``), bicubic up to the image size, plus white
  noise (``cfg["inputs"]["noise"]``): each image has its own large-scale
  content, as photographs do.
- :func:`build`, :func:`feed`, :func:`answer`: the program's predictor at a
  batch, calibrated and quantized by ``create_predictor``; its feed; its
  answer rows (the softmax output).
- :class:`Reference`: the plain reference (``reference/<cfg["reference"]>.py``
  over ``reference/qref.py``), int8 as the configuration states, or int4 for
  the control.
- :func:`compare`: the numbers compared, a row at a time (``logit_rel_err``,
  ``own_vs_other``).
- :func:`install`: the weights into the program's unoptimized graph.

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
import torch.nn.functional as F

from ..reference import qref

# the weight slots of each layer type of an unoptimized graph, in order
SLOTS = {"conv2d": ("Filter", "Bias"), "depthwise_conv2d": ("Filter", "Bias"),
         "batch_norm": ("Scale", "Bias", "Mean", "Variance"), "fc": ("W", "Bias")}


def model(cfg: dict):
    """The configuration's plain model: ``params``, ``fold``, ``forward``."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def _draw(spec: List[Tuple[str, tuple, str]], gen: torch.Generator,
          device: torch.device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor for every (name, shape, kind) of `spec`, in
    one normal draw.  Batch norms start as identity (their data-dependent
    mean and variance follow)."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, kind), v in zip(spec, torch.split(z, sizes)):
        if kind == "conv":
            v = v * math.sqrt(2.0 / math.prod(shape[:-1]))
        elif kind == "fc":
            v = v * math.sqrt(1.0 / shape[0])
        elif kind == "bias":
            v = 0.01 * v
        elif kind == "bn_gamma":
            v = 1.0 + 0.1 * v
        elif kind == "bn_beta":
            v = 0.05 * v
        elif kind == "bn_mean":
            v = torch.zeros_like(v)
        elif kind == "bn_var":
            v = torch.ones_like(v)
        else:
            raise ValueError(f"unknown weight kind {kind!r}")
        out[name] = v.reshape(shape)
    return out


def inputs(cfg: dict, gen: torch.Generator, n: int, device: torch.device) -> torch.Tensor:
    """`n` NHWC float32 images made from `gen` (see the module's text)."""
    size, ch = cfg["image_size"], cfg["image_channels"]
    grid, noise = int(cfg["inputs"]["grid"]), float(cfg["inputs"]["noise"])
    low = torch.randn((n, ch, grid, grid), generator=gen, device=device)
    img = F.interpolate(low, size=(size, size), mode="bicubic", align_corners=False)
    img = img.permute(0, 2, 3, 1).contiguous()
    return img + noise * torch.randn(img.shape, generator=gen, device=device)


def _float_logits(m, cfg: dict, p: dict, x: torch.Tensor, block: int) -> torch.Tensor:
    f32 = qref.Float32()
    return torch.cat([f32.run(lambda be, q, xb: m.forward(be, cfg, q, xb), p, x[i:i + block])
                      for i in range(0, len(x), block)])


def make(cfg: dict, gen: torch.Generator, device: torch.device) -> SimpleNamespace:
    """The weights (host float32 arrays, by the reference's names) and the
    calibration images (a host array), drawn in that order from `gen`."""
    m = model(cfg)
    spec = m.params(cfg)
    raw = _draw(spec, gen, device)
    calib = inputs(cfg, gen, int(cfg["calib_images"]), device)
    init = cfg["init"]
    names = {n[:-2]: n[:-2] for n, _, kind in spec if kind == "conv"}
    names["fc"] = (raw["fc.w"], raw["fc.b"])
    qref.DataInit(raw, float(init["bn_centre"]), init.get("gamma_scale")).run(
        lambda be, q, x: m.forward(be, cfg, q, x), names, calib)
    logits = _float_logits(m, cfg, m.fold(cfg, raw), calib, int(cfg["reference_block"]))
    factor = float(init["logit_std"]) / float(logits.std())
    raw["fc.w"].mul_(factor)
    raw["fc.b"].mul_(factor)
    flat = torch.cat([v.reshape(-1) for v in raw.values()]).cpu().numpy()
    host, off = {}, 0
    for name, v in raw.items():
        host[name] = flat[off:off + v.numel()].reshape(tuple(v.shape))
        off += v.numel()
    return SimpleNamespace(spec=spec, raw=host, calib=calib.cpu().numpy(),
                           info={"classifier_scale": factor})


def install(graph, spec: List[Tuple[str, tuple, str]], raw: Dict[str, np.ndarray]) -> None:
    """Put `raw` into the unoptimized `graph`, layer by layer in graph order
    against `spec`'s order; a layer type or shape that does not match
    raises."""
    names = []
    for op in graph.ops:
        slots = SLOTS.get(op.op_type, ())
        for slot in op.inputs:
            for n in op.inputs[slot]:
                if graph.vars[n].is_weight and slot not in slots:
                    raise ValueError(f"{op.op_type} has a weight in {slot}, "
                                     "which the reference does not know")
        names += [n for s in slots for n in op.inputs.get(s, [])]
    if len(names) != len(spec):
        raise ValueError(f"the graph has {len(names)} weights, the reference {len(spec)}")
    for n, (ref_name, shape, _) in zip(names, spec):
        if tuple(graph.vars[n].shape) != tuple(shape):
            raise ValueError(f"{n} has shape {graph.vars[n].shape}, the reference's "
                             f"{ref_name} {shape}")
        graph.weights[n] = np.array(raw[ref_name], copy=True)


def build(cfg: dict, made: SimpleNamespace, batch: int, device: torch.device):
    """The program's predictor at `batch`: the graph its model-building
    function makes, with `made`'s weights, calibrated on `made`'s images
    `batch` at a time and quantized by ``create_predictor``."""
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor

    mod, fn = cfg["program"]["build"].split(":")
    graph = getattr(importlib.import_module(mod), fn)(
        batch=batch, image_size=cfg["image_size"], num_classes=cfg["num_classes"],
        **cfg["program"]["kwargs"])
    install(graph, made.spec, made.raw)
    calib = made.calib
    if len(calib) % batch:
        raise ValueError(f"{len(calib)} calibration images do not split into batches of {batch}")
    name = graph.inputs[0]
    return create_predictor(graph, quant=QuantConfig(**cfg["program"]["quant"]),
                            calib_batches=[{name: calib[i:i + batch]}
                                           for i in range(0, len(calib), batch)],
                            device=device)


def feed(pred, x) -> dict:
    return {pred.graph.inputs[0]: x}


def answer(pred, outputs: dict):
    return outputs[pred.graph.outputs[0]]


class Reference:
    """The reference prepared from `made` (batch norms folded, abs-maxes
    calibrated on its images): ``ref(x)`` gives float64 softmax rows at
    int8, ``ref(x, low=True)`` at int4, the control."""

    def __init__(self, cfg: dict, made: SimpleNamespace, device: torch.device):
        raw = {k: torch.from_numpy(v).to(device) for k, v in made.raw.items()}
        block = int(cfg["reference_block"])
        calib = [torch.from_numpy(made.calib[i:i + block]).to(device)
                 for i in range(0, len(made.calib), block)]
        self.ref = qref.Reference(model(cfg), cfg, raw, calib)

    def __call__(self, x: torch.Tensor, low: bool = False) -> torch.Tensor:
        return self.ref(x, 4 if low else 8)


def _centred(p: torch.Tensor) -> torch.Tensor:
    """``log p`` centred over the classes, float64: the logits as far as
    softmax keeps them.  A zero probability reads as 1e-45."""
    lp = torch.log(p.to(torch.float64).clamp_min(1e-45))
    return lp - lp.mean(dim=-1, keepdim=True)


def compare(got: torch.Tensor, pool: torch.Tensor, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The numbers compared for each row of `got`, whose own reference row
    is ``pool[idx]`` (`pool`: the reference's answers to every input the
    traffic can send).  The relative error of a row against a reference row
    is ``|g - w| / |w|`` over centred log-probabilities.

    - ``logit_rel_err``: the error against the row's own reference;
    - ``own_vs_other``: that error over the smallest error against another
      input's reference row, so an answer that belongs to another input
      (a stale buffer, rows exchanged) reads large however close the
      inputs' answers lie."""
    g, w = _centred(got.to(pool.device)), _centred(pool)
    d = torch.cdist(g, w) / w.norm(dim=-1)
    rows = torch.arange(len(g), device=d.device)
    own = d[rows, idx]
    d[rows, idx] = math.inf
    other = d.min(dim=-1).values if d.shape[1] > 1 else torch.full_like(own, math.inf)
    return {"logit_rel_err": own, "own_vs_other": own / other}
