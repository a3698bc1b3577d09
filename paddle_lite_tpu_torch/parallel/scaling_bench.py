"""Weak-scaling bench of :class:`~.sharding.ShardedPredictor`.

Port of ``paddle_lite_tpu/parallel/scaling_bench.py``: the int8 model
served over n devices with the per-device batch held constant (weak
scaling, the serving configuration), compiled as the reference's
``jax.jit`` loop is (the predictor's default: CUDA graphs cut at the
collectives), images/s by rank 0's host clock around `loop` requests
between two barriers, and ``efficiency(n) =
ips(n) / (n · ips(first n) / first n)``: the same rows ``{"devices", "dp",
"tp", "batch", "images_per_sec", "efficiency"}``.

Each n spawns n processes (``distributed.spawn``): gloo ranks on the CPU
under ``--cpu-devices N`` (a proxy: the "devices" share the host's cores
and memory), one rank a card on GPUs (NCCL).  The sweep stops at the
devices there are, and says so: on a machine with one card that is n = 1.

    python3 -m paddle_lite_tpu_torch.parallel.scaling_bench --cpu-devices 2
"""

from __future__ import annotations

import argparse
import importlib
import json
import time
from typing import List, Optional

import numpy as np
import torch

from . import distributed


def _throughput(graph, dp: int, tp: int, device: str, backend: str, loop: int) -> dict:
    """One rank's reading: ``loop`` requests of the whole batch through
    the compiled predictor, timed on the host clock between barriers after
    one warm-up request (which also captures its CUDA graphs)."""
    import torch.distributed as dist

    from .sharding import MeshConfig, ShardedPredictor

    n = dp * tp
    local = torch.device(device if device == "cpu" else f"cuda:{dist.get_rank()}")
    if local.type == "cuda":
        torch.cuda.set_device(local)  # NCCL's barrier runs on the current card
    devices = ["cpu"] * n if device == "cpu" else [f"cuda:{r}" for r in range(n)]
    pred = ShardedPredictor(graph, MeshConfig(data=dp, model=tp), devices=devices,
                            backend=backend)
    x = graph.inputs[0]
    feed = {x: np.random.default_rng(0).normal(size=graph.vars[x].shape).astype(np.float32)}

    def sync():
        if local.type == "cuda":
            torch.cuda.synchronize(local)
        dist.barrier()

    pred.run(feed)  # warm-up and capture
    sync()
    t0 = time.perf_counter()
    for _ in range(loop):
        pred.run(feed)
    sync()
    return {"seconds": time.perf_counter() - t0}


def devices_here(cpu_devices: int) -> int:
    """The devices a sweep may use: `cpu_devices` gloo ranks on the CPU, or
    the cards present."""
    return cpu_devices if cpu_devices else torch.cuda.device_count()


def run_scaling(model_builder, *, per_device_batch: int = 16, image_size: int = 64,
                device_counts=(1, 2, 4, 8), tp: int = 1, quantize: bool = True,
                cpu_devices: int = 0, loop: int = 8) -> List[dict]:
    """Weak-scaling sweep; `model_builder(batch=, image_size=)` returns an
    unoptimized graph, built again for each n.  Rows as they are measured
    are also printed (one JSON line each)."""
    from .. import QuantConfig
    from ..tools.opt import optimize

    device = "cpu" if cpu_devices else "cuda"
    backend = "gloo" if cpu_devices else "nccl"
    have = devices_here(cpu_devices)
    results: List[dict] = []
    base_ips: Optional[float] = None
    rng = np.random.default_rng(0)
    for n in device_counts:
        if n > have:
            print(f"scaling_bench: stops at n = {results[-1]['devices'] if results else 0}: "
                  f"{have} {'CPU rank' if cpu_devices else 'card'}(s) here, n = {n} needs more",
                  flush=True)
            break
        if n < tp or n % tp:
            continue  # the mesh must factor as dp x tp
        dp = n // tp
        batch = per_device_batch * dp
        g = model_builder(batch=batch, image_size=image_size)
        x = g.inputs[0]
        feed = {x: rng.normal(size=g.vars[x].shape).astype(np.float32)}
        calib = "cpu" if cpu_devices else "cuda:0"
        optimize(g, quant=QuantConfig() if quantize else None,
                 calib_batches=[feed] if quantize else None, device=calib)
        res = distributed.spawn(_throughput, n, (g, dp, tp, device, backend, loop),
                                backend=backend,
                                threads=1 if cpu_devices else None)
        ips = batch * loop / res[0]["seconds"]
        if base_ips is None:
            base_ips = ips / n  # per device at the sweep's first n
        row = {"devices": n, "dp": dp, "tp": tp, "batch": batch,
               "images_per_sec": round(ips, 1), "efficiency": round(ips / (n * base_ips), 3)}
        print(json.dumps(row), flush=True)
        results.append(row)
    return results


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="mobilenet_v1")
    p.add_argument("--per-device-batch", type=int, default=16)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--loop", type=int, default=8)
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="N gloo ranks on the CPU (testing); default: the cards present")
    args = p.parse_args(argv)
    mod = importlib.import_module(f"paddle_lite_tpu_torch.models.{args.model}")
    res = run_scaling(mod.build, per_device_batch=args.per_device_batch,
                      image_size=args.image_size, tp=args.tp, cpu_devices=args.cpu_devices,
                      loop=args.loop)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
