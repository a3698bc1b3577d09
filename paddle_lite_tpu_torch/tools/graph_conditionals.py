"""Conditional CUDA graph nodes on the card: what torch offers, and the
port's own.

Prints one JSON line.  ``offered``: the torch and CUDA versions, the
driver, the card and its power limit, whether ``torch.cuda.CUDAGraph`` has
``begin_capture_to_if_node``, ``end_capture_to_conditional_node`` and
``get_currently_capturing_graph`` (the calls with which torch 2.13's
``torch._higher_order_ops.cudagraph_conditional_nodes`` captures
``torch.cond`` under an IF node; the card's torch 2.11 has none of them),
and whether ``torch._C`` has the calls that route one thread's allocations
to a pool, which a body's capture needs.  ``toys``: small functions whose
control flow runs through the port's own conditional nodes
(``core/conditional_nodes``, library ``csrc/graph_cond.cu``), each captured
once by ``core/executor.capture_cuda_graph`` and replayed on several
inputs, every replay bit-equal to the same function run eagerly (its
control flow a host loop):

- ``count``: a WHILE loop x <- x·0.5 + 0.25 that runs 0, 3 and
  ``max_iters`` trips (a device trip counter against a limit);
- ``if_else``: the two-IF form of a branch, both ways;
- ``while_in_if``: that loop inside the IF's body;
- ``allocates``: a loop whose body allocates each trip (the bodies' pool's
  reserved bytes reported);
- ``gemm``: a loop whose body launches the int8 GEMM kernel
  (``csrc/int8_gemm.cu``): the wrapper's launches counted at capture; the
  kernel's launches that torch.profiler reports in one replay of five
  trips (information: it reports a kernel inside a WHILE body once a
  replay);
- ``matmul_topk``: a loop whose body runs an fp32 ``torch.mm`` (cuBLAS) and
  ``torch.topk``, as the beam-search decode loop's body does.

``--decode`` also profiles one compiled beam-search decode request
(``models/beam_decode``: b32, beam 4, hidden 1,024, vocabulary 18,000, 32
steps) through ``Predictor`` with the input on the card: ms a trip on the
host clock (10 requests) and the device time of its kernels a trip under
``torch.profiler``.  The script exits 1 if a toy fails.

Run on the card: ``python3 -m paddle_lite_tpu_torch.tools.graph_conditionals
[--decode]``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, List

import numpy as np
import torch

CALLS = ("begin_capture_to_if_node", "end_capture_to_conditional_node",
         "get_currently_capturing_graph")
POOL_CALLS = ("_graph_pool_handle", "_cuda_beginAllocateCurrentThreadToPool",
              "_cuda_endAllocateToPool", "_cuda_releasePool")
MAX_ITERS = 10
DECODE = dict(batch=32, beam=4, hidden=1024, vocab=18000, steps=32)


def _nvsmi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()


def offered() -> dict:
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "driver": _nvsmi("driver_version"), "card": _nvsmi("name,power.limit"),
            "calls": {c: hasattr(torch.cuda.CUDAGraph, c) for c in CALLS},
            "pool_calls": {c: hasattr(torch._C, c) for c in POOL_CALLS}}


def _run_toy(fn: Callable[[], None], outs: List[torch.Tensor],
             feeds: List[Callable[[], None]]) -> dict:
    """`fn` on each feed eagerly, then captured once and replayed on each:
    whether every replay's `outs` equal the eager run's bit for bit."""
    from ..core.executor import capture_cuda_graph

    want = []
    for feed in feeds:
        feed()
        fn()
        want.append([o.clone() for o in outs])
    torch.cuda.synchronize()
    graph, _ = capture_cuda_graph(fn)
    got = []
    for feed in feeds:
        feed()
        graph.replay()
        got.append([o.clone() for o in outs])
    torch.cuda.synchronize()
    equal = [all(torch.equal(a, b) for a, b in zip(w, g)) for w, g in zip(want, got)]
    return {"equal": equal, "ok": all(equal), "graph": graph,
            "got": [[o.flatten()[:4].tolist() for o in g] for g in got]}


def _counting_loop(dev, x_in: torch.Tensor, limit: torch.Tensor, body_extra=None):
    """(fn, x, counter): x <- x·0.5 + 0.25 while counter < limit and
    counter < MAX_ITERS."""
    from ..core import conditional_nodes as cn

    x = torch.empty_like(x_in)
    counter = torch.zeros((), dtype=torch.int32, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)

    def next_flag():
        torch.logical_and(counter < limit, counter < MAX_ITERS, out=flag)

    def body():
        if body_extra is None:
            x.mul_(0.5).add_(0.25)
        else:
            body_extra(x)
        counter.add_(1)
        next_flag()

    def fn():
        x.copy_(x_in)
        counter.zero_()
        next_flag()
        cn.while_node(flag, body)

    return fn, x, counter


def toys() -> dict:
    from ..core import conditional_nodes as cn
    from ..core.device import fp32_exact
    from ..ops.kernels import int8_matmul as km

    dev = torch.device("cuda")
    out = {}
    x_in = torch.arange(8.0, device=dev)
    limit = torch.zeros((), dtype=torch.int32, device=dev)
    pred = torch.zeros((), dtype=torch.bool, device=dev)

    def set_limit(v):
        return lambda: limit.fill_(v)

    def set_pred(v):
        return lambda: pred.fill_(v)

    fn, x, counter = _counting_loop(dev, x_in, limit)
    r = _run_toy(fn, [x, counter], [set_limit(0), set_limit(3), set_limit(100)])
    r["trips"] = [g[1][0] for g in r["got"]]
    r["ok"] = r["ok"] and r["trips"] == [0, 3, MAX_ITERS]
    out["count"] = r

    y = torch.empty_like(x_in)
    r = _run_toy(lambda: cn.if_node(pred, lambda: y.copy_(x_in * 2.0 + 1.0),
                                    lambda: y.copy_(x_in - 1.0)),
                 [y], [set_pred(True), set_pred(False)])
    out["if_else"] = r

    loop, x2, counter2 = _counting_loop(dev, x_in, limit)
    limit.fill_(4)
    r = _run_toy(lambda: cn.if_node(pred, loop, lambda: (x2.copy_(x_in), counter2.zero_())),
                 [x2, counter2], [set_pred(True), set_pred(False)])
    out["while_in_if"] = r

    def allocating(x):
        t = x * 0.5
        x.copy_(t + 0.25)

    fn, x3, counter3 = _counting_loop(dev, x_in, limit, allocating)
    r = _run_toy(fn, [x3, counter3], [set_limit(2), set_limit(7)])
    r["pool_bytes"] = _pool_bytes()
    out["allocates"] = r

    rng = np.random.default_rng(21)
    m, k, n = 64, 128, 96
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(dev)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(dev)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32)).to(dev)
    acc = torch.zeros((m, n), device=dev)
    acc_in = torch.zeros((m, n), device=dev)

    def gemm_body(_x):
        acc.add_(km.int8_matmul(xq, wq, scale))

    fn, x4, counter4 = _counting_loop(dev, x_in, limit, gemm_body)

    def gemm_fn():
        acc.copy_(acc_in)
        fn()

    km.launches = 0
    r = _run_toy(gemm_fn, [acc, counter4], [set_limit(3), set_limit(5)])
    r["wrapper_launches"] = km.launches  # 3 + 5 eager trips, 1 at capture
    r["profiled_kernels_a_replay"] = _profiled_kernels(r["graph"], limit, 5, "int8_gemm")
    r["ok"] = r["ok"] and r["wrapper_launches"] == 3 + 5 + 1
    out["gemm"] = r

    h_in = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32) / 8).to(dev)
    h = torch.empty_like(h_in)

    def mm_body(_x):
        vals, idx = torch.topk(torch.tanh(h @ w), 4, dim=-1)
        h.mul_(0.5).add_(vals.sum(-1, keepdim=True) + idx[:, :1].to(h.dtype) * 1e-3)

    fn, _, counter5 = _counting_loop(dev, x_in, limit, mm_body)

    def mm_fn():
        h.copy_(h_in)
        fn()

    with fp32_exact():
        r = _run_toy(mm_fn, [h, counter5], [set_limit(3), set_limit(6)])
    out["matmul_topk"] = r
    for v in out.values():
        v.pop("graph", None)
    out["set_conditional_launches"] = cn.launches
    out["nodes"] = cn.nodes
    return out


def _pool_bytes() -> dict:
    """Reserved bytes by memory pool id, from the allocator's snapshot."""
    by = {}
    for seg in torch.cuda.memory_snapshot():
        key = str(seg.get("segment_pool_id"))
        by[key] = by.get(key, 0) + seg["total_size"]
    return by


def _profiled_kernels(graph, limit: torch.Tensor, trips: int, symbol: str) -> int:
    """Device launches of kernels whose name holds `symbol` in one replay of
    `graph` with `trips` trips, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    limit.fill_(trips)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.key)


def decode_trip_profile() -> dict:
    """ms a trip of one compiled decode request (host clock, 10 requests,
    input on the card) and its device kernels' time a trip under
    torch.profiler (one request), with the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from ..models import beam_decode
    from ..runtime.predictor import Predictor

    dev = torch.device("cuda")
    g = beam_decode.build(**DECODE)
    feed = beam_decode.feed(**{k: DECODE[k] for k in ("batch", "beam", "hidden")})
    on = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    pred = Predictor(g, device=dev)
    pred.run(on)
    pred.run(on)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.run(on)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred.run(on)
        torch.cuda.synchronize()
    rows = []
    host = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            rows.append((us / 1e3, e.count, e.key[:70]))
        else:
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key[:50]))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    steps = DECODE["steps"]
    fn = pred._fn
    return {"ms_a_trip_wall": wall / steps, "ms_a_request_wall": wall,
            "device_ms_a_trip": sum(r[0] for r in rows) / steps,
            "kernels_a_trip": sum(r[1] for r in rows) / steps,
            "top_device": rows[:10], "top_host": host[:10],
            "graphs": fn.n_graphs, "segments": fn.n_segments}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode", action="store_true",
                    help="also profile a compiled decode request")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("graph_conditionals: no CUDA device")
    res = {"offered": offered(), "toys": toys()}
    if args.decode:
        res["decode"] = decode_trip_profile()
    print(json.dumps(res))
    if not all(v["ok"] for v in res["toys"].values() if isinstance(v, dict)):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
