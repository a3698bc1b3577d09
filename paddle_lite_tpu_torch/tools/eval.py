"""Accuracy evaluation harness — the reference's golden-output integration
tests and the BASELINE top-1-delta contract, as a reusable loop.

Port of ``paddle_lite_tpu/tools/eval.py`` (``:1-70``).  No public dataset
ships here, so the harness takes any iterator of ``(inputs_dict, labels)``
batches (plug in an ImageNet loader in production;
:func:`synthetic_dataset` provides a smoke source).  The headline API is
:func:`top1_delta`: int8 top-1 against fp32 on the same batches through
both predictors.  A predictor is anything with ``run(inputs) -> {name:
array or tensor}`` (``runtime.predictor.Predictor``, whose outputs are
tensors on its device, read back here).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EvalResult:
    top1: float
    top5: float
    n: int


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _first(out: dict, name=None) -> np.ndarray:
    return _numpy(out[name] if name else next(iter(out.values())))


def evaluate(predictor, dataset, *, output_name: str = None) -> EvalResult:
    """Top-1/top-5 over ``dataset`` yielding (inputs_dict, labels)."""
    correct1 = correct5 = total = 0
    for inputs, labels in dataset:
        logits = _first(predictor.run(inputs), output_name)
        labels = np.asarray(labels)
        top5 = np.argsort(logits, axis=-1)[:, -5:]
        correct1 += int((top5[:, -1] == labels).sum())
        correct5 += int((top5 == labels[:, None]).any(-1).sum())
        total += labels.shape[0]
    return EvalResult(top1=correct1 / total, top5=correct5 / total, n=total)


def top1_delta(fp32_predictor, int8_predictor, dataset) -> dict:
    """The BASELINE accuracy contract: int8 top-1 delta vs fp32 on the same
    batches, plus prediction agreement."""
    batches = list(dataset)
    r32 = evaluate(fp32_predictor, batches)
    r8 = evaluate(int8_predictor, batches)
    agree = total = 0
    for inputs, _ in batches:
        a = _first(fp32_predictor.run(inputs)).argmax(-1)
        b = _first(int8_predictor.run(inputs)).argmax(-1)
        agree += int((a == b).sum())
        total += a.shape[0]
    return {
        "fp32_top1": r32.top1,
        "int8_top1": r8.top1,
        "top1_delta": r32.top1 - r8.top1,
        "prediction_agreement": agree / total,
        "n": r32.n,
    }


def synthetic_dataset(input_name: str, shape, num_classes: int,
                      batches: int = 4, seed: int = 0):
    """Labeled synthetic batches (labels arbitrary — for smoke/plumbing)."""
    rng = np.random.default_rng(seed)
    for _ in range(batches):
        x = rng.normal(size=shape).astype(np.float32)
        y = rng.integers(0, num_classes, (shape[0],))
        yield {input_name: x}, y
