"""Multi-model benchmark — port of ``paddle_lite_tpu/tools/benchmark.py``
(the ``lite/api/benchmark.cc`` analog).

Measures int8 (and optionally fp32) throughput of a zoo model through
:func:`~..core.executor.compile_graph`, one JSON object a config::

    python3 -m paddle_lite_tpu_torch.tools.benchmark --model mobilenet_v1 --batch 64

- ``method="loop"`` (:func:`device_throughput`): the reference's
  iteration-delta method.  On the card, CUDA events around ``1 + loop``
  calls of the compiled graph (input already on the card) minus one call,
  the loop grown until the delta is at least 0.4 s; the median of five
  deltas.  On the CPU (tests), a host clock in place of the events.
- ``method="dispatch"`` (:func:`dispatch_throughput`): a host clock around
  ``calls`` runs of ``Predictor.run`` with numpy inputs, ending in one
  synchronise: the serving number, the input's copy to the card included.

Runs on the card unless ``--device cpu`` is asked for.  Every result names
the device it ran on (the card's name and power limit).  Models the port
does not have yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device

PORTED = ("mobilenet_v1", "resnet", "mobilenet_v3", "ssd", "ppocr_det", "dbnet",
          "ppocr_rec", "crnn", "ppocr_rec_long", "crnn_long")
MIN_WINDOW_S = 0.4  # the loop method's timed window, long beside one call's jitter
NOT_PORTED = ("ernie_tiny",)


def resolve_builder(model: str) -> Callable:
    """Model name → its ``build(batch=..., image_size=...)``; the two heads
    of ``models/ppocr.py`` as the reference builds them
    (``tools/benchmark.py:32-50`` there): DBNet at 640 px, CRNN at strip
    width 320, the long strip at width 1600 with hidden 64 (an
    ``image_size`` of None keeps those)."""
    if model in ("ppocr_det", "dbnet"):
        from ..models.ppocr import build_det

        return lambda batch, image_size=None, **kw: build_det(
            batch=batch, image_size=image_size or 640)
    if model in ("ppocr_rec", "crnn"):
        from ..models.ppocr import build_rec

        return lambda batch, image_size=None, **kw: build_rec(
            batch=batch, width=image_size or 320)
    if model in ("ppocr_rec_long", "crnn_long"):
        from ..models.ppocr import build_rec

        return lambda batch, image_size=None, **kw: build_rec(
            batch=batch, width=image_size or 1600, hidden=64)
    if model in PORTED:
        return importlib.import_module(f"..models.{model}", __package__).build
    if model in NOT_PORTED:
        raise NotImplementedError(
            f"model {model!r} is not ported to paddle_lite_tpu_torch yet "
            f"(ported: {', '.join(PORTED)})")
    raise ValueError(f"unknown model {model!r}; known: {PORTED + NOT_PORTED}")


def card(device: torch.device) -> Dict[str, object]:
    """The device a number was taken on: the card's name and power limit
    (``nvidia-smi``), or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        out = None
    return {"name": torch.cuda.get_device_name(device), "power_limit": out}


def _on(feed: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in feed.items()}


def device_throughput(graph, feed, *, device: DeviceLike = None) -> float:
    """Items/s of the compiled graph by the iteration-delta method, the
    input already on the device."""
    from ..core.executor import compile_graph

    dev = resolve_device(device)
    fn, weights = compile_graph(graph, device=dev)
    inputs = _on(feed, dev)
    batch = next(iter(feed.values())).shape[0]
    fn(weights, inputs)  # warm-up and capture

    def timed(n: int) -> float:
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn(weights, inputs)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            fn(weights, inputs)
        return time.perf_counter() - t0

    timed(1)
    # grow the loop until the median delta spans MIN_WINDOW_S
    loop = 16
    while True:
        d = float(np.median([timed(1 + loop) - timed(1) for _ in range(3)]))
        if d >= MIN_WINDOW_S or loop >= 1 << 20:
            break
        scale = 1.25 * MIN_WINDOW_S / max(d, 1e-3)
        loop = min(max(int(loop * scale) + 1, loop * 2), 1 << 20)
    deltas = [timed(1 + loop) - timed(1) for _ in range(5)]
    good = [x for x in deltas if x > MIN_WINDOW_S / 4]
    if not good:
        raise RuntimeError(f"unstable measurement: deltas {deltas} at loop={loop}")
    return batch * loop / float(np.median(good))


def dispatch_throughput(graph, feed, *, device: DeviceLike = None,
                        calls: int = 30) -> float:
    """Items/s of ``calls`` runs of ``Predictor.run`` with numpy inputs, by
    the host clock, ending in one synchronise: dispatch and the input's copy
    to the card included."""
    from ..runtime.predictor import Predictor

    dev = resolve_device(device)
    pred = Predictor(graph, device=dev)
    batch = next(iter(feed.values())).shape[0]
    pred.run(feed)  # warm-up and capture
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        pred.run(feed)
    sync()
    return batch * calls / (time.perf_counter() - t0)


def bench_model(model: str, *, batch: int, image_size: Optional[int] = None,
                int8: bool = True, with_fp32: bool = False, method: str = "loop",
                zoo_config: bool = True, device: DeviceLike = None) -> dict:
    """The reference's keys (``model``, ``batch``, ``method``,
    ``int8_items_per_sec``; with ``with_fp32`` also ``fp32_items_per_sec``
    and ``speedup``) and ``device``, the card the numbers were taken on.
    The int8 ``QuantConfig`` is ``models/zoo_config.py``'s entry, or with
    ``zoo_config=False`` the defaults.  ``image_size`` None is the
    model's own default (224 px; DBNet 640; CRNN strip widths 320 and
    1600).  (The reference's ``seq_len``, ``island_dtype`` and
    ``dw_compute`` serve models and options the port does not have yet.)"""
    from ..models.zoo_config import recommended_quant
    from ..quant.quantize_pass import QuantConfig
    from .opt import optimize

    build = resolve_builder(model)
    dev = resolve_device(device)

    def builder(batch, image_size):
        return build(batch=batch) if image_size is None else \
            build(batch=batch, image_size=image_size)

    rng = np.random.default_rng(0)

    def make_feed(g):
        feed = {}
        for name in g.inputs:
            shape = g.vars[name].shape
            dt = torch.empty(0, dtype=g.vars[name].precision.torch_dtype).numpy().dtype
            if np.issubdtype(dt, np.integer):
                feed[name] = rng.integers(0, 100, shape).astype(dt)
            else:
                feed[name] = rng.normal(size=shape).astype(dt)
        return feed

    measure = device_throughput if method == "loop" else dispatch_throughput
    result = {"model": model, "batch": batch, "method": method, "device": card(dev)}
    if with_fp32:
        # the same fusion pipeline; only quantization differs
        g32 = optimize(builder(batch=batch, image_size=image_size), device=dev)
        result["fp32_items_per_sec"] = round(measure(g32, make_feed(g32), device=dev), 1)
    if int8:
        g8 = builder(batch=batch, image_size=image_size)
        feed = make_feed(g8)
        quant = recommended_quant(model) if zoo_config else QuantConfig()
        optimize(g8, quant=quant, calib_batches=[feed], device=dev)
        result["int8_items_per_sec"] = round(measure(g8, feed, device=dev), 1)
        if with_fp32:
            result["speedup"] = round(
                result["int8_items_per_sec"] / result["fp32_items_per_sec"], 3)
    return result


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="mobilenet_v1")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--image-size", type=int, default=None,
                   help="pixels (a CRNN's strip width); the model's default if left out")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--method", default="loop", choices=["loop", "dispatch"])
    p.add_argument("--no-zoo-config", action="store_true",
                   help="ignore models/zoo_config.py; quantize with the "
                        "QuantConfig defaults (fp32 islands for SSD and CRNN)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    print(json.dumps(bench_model(
        args.model, batch=args.batch, image_size=args.image_size,
        with_fp32=args.fp32, method=args.method,
        zoo_config=not args.no_zoo_config, device=args.device)))


if __name__ == "__main__":
    main()
