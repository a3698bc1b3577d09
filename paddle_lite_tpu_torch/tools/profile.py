"""Profilers — analog of ``lite/core/profile/``.

Port of the precision half of ``paddle_lite_tpu/tools/profile.py``
(``:29-111`` there): :func:`precision_report` ≈ ``precision_profiler.h``
runs the fp32 graph and the quantized graph on the same inputs, captures
every intermediate, and reports per-layer mean / std / absmax plus the
int8-vs-fp32 delta — layer-wise quantization-error hunting.  Both graphs run
through the eager loop (``core/executor.build_callable``, the only path
with the capture hook) on the given device, and the statistics are reduced
there, in float64, so only one small table comes back to the host.

The latency half (``:114-410`` there): :func:`latency_report` attributes a
model's device time to its ops by prefix differencing, :func:`_isotonic_fit`
keeps the attribution's parts summing to the whole, :func:`per_type_summary`
sums it by op type, and :func:`_main` is the module's command line::

    python -m paddle_lite_tpu_torch.tools.profile --model mobilenet_v1 --batch 64

The reference times each prefix inside one jitted ``fori_loop`` (its
iteration-delta method), so the TPU's dispatch floor stays out of the
number.  Here each prefix is a :class:`~..core.executor.CompiledGraph` of
the graph's first k ops, captured as a CUDA graph, and timed by CUDA events
around ``1 + loop`` back-to-back replays minus one replay: the card runs
the replays without waiting on the host, so the host's launch floor stays
out the same way.  On the CPU (tests) a host clock stands in for the
events; such a number is not a device time.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.executor import (CompiledGraph, ExecutionContext, build_callable,
                             stage_weights)
from ..core.ir import Graph
from ..core.types import Precision


@dataclasses.dataclass
class LayerDelta:
    var: str
    op_type: str
    precision: str
    mean: float
    std: float
    absmax: float
    rel_err: float  # vs fp32 reference, max-normalized
    cos: float

    def row(self) -> str:
        return (f"{self.var:<32} {self.op_type:<18} {self.precision:<5} "
                f"mean={self.mean:+.4f} std={self.std:.4f} "
                f"absmax={self.absmax:.4f} rel={self.rel_err:.4f} "
                f"cos={self.cos:.5f}")


def _capture_all(graph: Graph, feed, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every graph input and op output of one eager run, on `device`."""
    caps: Dict[str, torch.Tensor] = {}
    run = build_callable(graph, device=device, capture=caps.__setitem__)
    run(stage_weights(graph, device), feed)
    return caps


def precision_report(
    fp32_graph: Graph,
    int8_graph: Graph,
    feed: Dict[str, np.ndarray],
    *,
    top: Optional[int] = None,
    device: DeviceLike = None,
) -> List[LayerDelta]:
    """Per-layer int8-vs-fp32 deltas; sorted worst-first when `top` given.

    An int8 value is dequantized by its scale in float32 (``x *
    float32(scale)``, as the reference does); the statistics are then
    taken in float64, where the reference takes them in float32."""
    dev = resolve_device(device)
    ref = _capture_all(fp32_graph, feed, dev)
    got = _capture_all(int8_graph, feed, dev)

    by_var_op = {}
    for op in int8_graph.ops:
        for n in op.output_names():
            by_var_op[n] = op.op_type

    names, rows = [], []
    for name, val in got.items():
        v = int8_graph.vars.get(name)
        if v is None or v.is_weight:
            continue
        x = val.to(torch.float32)
        if v.precision == Precision.INT8 and v.quant is not None:
            x = x * torch.tensor(np.float32(v.quant.scale[0]), device=dev)
        # compare against the fp32 var this one descends from (cast-inserted
        # vars are named <orig>.q8__k)
        r = ref.get(name.split(".q8__")[0])
        if r is None or r.shape != x.shape:
            continue
        x, r = x.double(), r.to(torch.float32).double()
        rel = (x - r).abs().max() / (r.abs().max() + 1e-9)
        cos = (x * r).sum() / (x.norm() * r.norm() + 1e-12)
        rows.append(torch.stack([x.mean(), x.std(unbiased=False), x.abs().max(),
                                 rel, cos]))
        names.append(name)
    table = torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 5))
    out = [LayerDelta(var=name, op_type=by_var_op.get(name, "input"),
                      precision=int8_graph.vars[name].precision.value,
                      mean=float(m), std=float(s), absmax=float(a),
                      rel_err=float(re), cos=float(c))
           for name, (m, s, a, re, c) in zip(names, table)]
    if top:
        out.sort(key=lambda d: d.cos)
        out = out[:top]
    return out


def print_precision_report(fp32_graph, int8_graph, feed, top=None,
                           device: DeviceLike = None) -> None:
    rows = precision_report(fp32_graph, int8_graph, feed, top=top, device=device)
    print(f"{'var':<32} {'op':<18} prec  stats")
    for r in rows:
        print(r.row())


def _isotonic_fit(xs: List[float]) -> List[float]:
    """Pool-adjacent-violators: the least-squares *monotone non-decreasing*
    fit of a sequence (``profile.py:114`` there).  The cumulative-prefix
    cost curve is non-decreasing in k, but each point carries its own
    measurement noise; clipping negative consecutive diffs at zero would
    rectify that noise into a positive bias.  Diffs of the fit are
    non-negative and telescope exactly to the final prefix's cost, so the
    parts sum to the whole by construction."""
    blocks: List[List[float]] = []  # [sum, count]
    for v in xs:
        blocks.append([float(v), 1.0])
        while (len(blocks) > 1
               and blocks[-2][0] * blocks[-1][1]
               > blocks[-1][0] * blocks[-2][1]):
            s, n = blocks.pop()
            blocks[-1][0] += s
            blocks[-1][1] += n
    out: List[float] = []
    for s, n in blocks:
        out.extend([s / n] * int(n))
    return out


def _prefix(graph: Graph, order, k: int, last_use: Dict[str, int]) -> Graph:
    """The graph of the first k ops of `order`, its outputs the live
    frontier at the cut: every var the prefix makes that a later op or the
    graph's outputs read (``profile.py:192-206`` there: a shape-only
    consumer such as ``prior_box`` must not let the chain before it fall
    away), else the last op's outputs."""
    ops_k = order[:k]
    produced = [n for op in ops_k for n in op.output_names()]
    outs = set(graph.outputs)
    frontier = [n for n in produced if n in outs or last_use.get(n, 0) > k] \
        or ops_k[-1].output_names()
    sub = Graph(f"{graph.name}[:{k}]")
    sub.vars = {n: copy.copy(v) for n, v in graph.vars.items()}
    sub.ops = list(ops_k)
    sub.inputs = list(graph.inputs)
    sub.outputs = frontier
    sub.weights = graph.weights
    sub.meta = graph.meta
    sub.rebuild_links()
    return sub


def latency_report(graph: Graph, feed: Dict[str, np.ndarray], *,
                   min_window: float = 0.3, reps: int = 3,
                   ks: Optional[List[int]] = None, progress=None,
                   device: DeviceLike = None) -> List[dict]:
    """Per-op device time by prefix differencing (the module's docstring).

    Each prefix's time a run is ``(t(1 + loop) - t(1)) / loop``, the loop
    grown until the delta spans ``min_window`` seconds, the median of
    ``reps`` deltas.  Rows keep the reference's keys: ``op`` / ``id`` of the
    prefix's last op, ``k``, ``n_ops`` (ops since the last prefix),
    ``cum_ms`` (the prefix), ``ms_raw`` (its delta), ``loop``, and from the
    isotonic fit of the ``cum_ms`` curve ``cum_ms_fit`` and ``ms``, which
    sum to the last ``cum_ms_fit`` by construction.

    ``ks``: prefix lengths (1-based, ascending) to time, e.g. block
    boundaries, when per-op rows take too long; a row then covers the ops
    (ks[i-1], ks[i]].  Runs on the card unless the CPU is asked for."""
    dev = resolve_device(device)
    order = graph.topological_order()
    weights = stage_weights(graph, dev)
    ctx = ExecutionContext(graph=graph, device=dev)  # one set of per-op constants
    last_use: Dict[str, int] = {}
    for idx, op_ in enumerate(order, 1):
        for n in op_.input_names():
            last_use[n] = idx

    def timer(fn):
        if dev.type == "cuda":
            def t(n: int) -> float:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    fn.run_static()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3
        else:
            def t(n: int) -> float:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn.run_static()
                return time.perf_counter() - t0
        return t

    ks = list(ks) if ks is not None else list(range(1, len(order) + 1))
    results: List[dict] = []
    prev_cum, prev_k = 0.0, 0
    est = 0.0  # seconds a run: the last prefix's (prefixes only grow)
    for k in ks:
        fn = CompiledGraph(_prefix(graph, order, k, last_use), dev, weights, ctx)
        fn.warm_up(weights, feed)
        timed = timer(fn)
        timed(1)  # the capture, on the card
        est = max(est, timed(1), 1e-7)  # one run, its launch included
        # a short probe (about a third of the window) refines the estimate
        probe = max(min(int(min_window / 3 / est), 4096), 8)
        est = max(max(timed(1 + probe) - timed(1), 1e-6) / probe, 1e-7)
        loop = min(max(int(min_window * 1.3 / est) + 1, 8), 1 << 22)
        while True:
            d = float(np.median([timed(1 + loop) - timed(1) for _ in range(3)]))
            if d >= min_window or loop >= 1 << 22:
                break
            loop = min(max(int(loop * min_window * 1.3 / max(d, 1e-6)) + 1, loop * 2),
                       1 << 22)
        deltas = [timed(1 + loop) - timed(1) for _ in range(reps)]
        good = [x for x in deltas if x > min_window / 4]
        dt = max(float(np.median(good or deltas)), 0.0) / loop
        est = max(dt, 1e-7)
        row = {"op": order[k - 1].op_type, "id": order[k - 1].id, "k": k,
               "n_ops": k - prev_k, "cum_ms": dt * 1e3,
               "ms_raw": (dt - prev_cum) * 1e3, "loop": loop}
        results.append(row)
        if progress is not None:
            progress(row)
        prev_cum, prev_k = dt, k
        del fn, timed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    fit = _isotonic_fit([r["cum_ms"] for r in results])
    for i, r in enumerate(results):
        r["cum_ms_fit"] = fit[i]
        r["ms"] = fit[i] - (fit[i - 1] if i else 0.0)
    return results


def per_type_summary(rows: List[dict]) -> List[dict]:
    """:func:`latency_report` rows summed by op type, costliest first.  The
    sums are of the fitted per-op ``ms``, so ``sum(t["ms"])`` equals the
    last row's ``cum_ms_fit``, the whole-model prefix."""
    agg: Dict[str, dict] = {}
    for r in rows:
        a = agg.setdefault(r["op"], {"op": r["op"], "ms": 0.0, "rows": 0})
        a["ms"] += r["ms"]
        a["rows"] += 1
    return sorted(agg.values(), key=lambda a: -a["ms"])


def model_feed(graph: Graph, seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded feed for `graph`'s inputs: integer ids in [0, 100), else
    N(0, 1) (``profile.py:364-371`` there)."""
    rng = np.random.default_rng(seed)
    feed = {}
    for name in graph.inputs:
        shape = graph.vars[name].shape
        dt = torch.empty(0, dtype=graph.vars[name].precision.torch_dtype).numpy().dtype
        feed[name] = (rng.integers(0, 100, shape).astype(dt)
                      if np.issubdtype(dt, np.integer)
                      else rng.normal(size=shape).astype(dt))
    return feed


def _main() -> None:
    """Per-op latency profile of a zoo model on the card (the reference's
    ``_main``): one JSON row a prefix to ``--out`` (JSONL, written as the
    rows come, then rewritten with the fitted attribution), and the
    per-type summary, whose sum is the whole-model prefix."""
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--fp32", action="store_true", help="skip quantization")
    p.add_argument("--island-dtype", default="auto",
                   help="'auto' = the zoo's recommended config (models/zoo_config.py)")
    p.add_argument("--out", default=None, help="JSONL path (default profile_<model>.jsonl)")
    p.add_argument("--min-window", type=float, default=0.3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    from .benchmark import card, resolve_builder
    from .opt import optimize

    builder = resolve_builder(args.model)
    if args.model == "ernie_tiny":
        graph = builder(batch=args.batch, seq_len=args.seq_len)
    else:
        graph = builder(batch=args.batch, image_size=args.image_size)
    feed = model_feed(graph)
    dev = resolve_device(args.device)
    if not args.fp32:
        from ..models.zoo_config import recommended_quant

        overrides = ({} if args.island_dtype == "auto"
                     else {"island_dtype": args.island_dtype})
        optimize(graph, quant=recommended_quant(args.model, **overrides),
                 calib_batches=[feed], device=dev)
    else:
        optimize(graph, device=dev)
    out_path = args.out or f"profile_{args.model}.jsonl"
    print(json.dumps({"device": card(dev)}))
    with open(out_path, "w") as f:
        def prog(row):
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(f"k={row['k']:>3} {row['op']:<18} ms={row['ms_raw']:.4f} "
                  f"cum={row['cum_ms']:.3f}", flush=True)

        rows = latency_report(graph, feed, min_window=args.min_window, progress=prog,
                              device=dev)
    with open(out_path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    total = rows[-1]["cum_ms_fit"] if rows else 0.0
    print(f"-- per-type (sums to the whole-model prefix {total:.3f} ms) --")
    for t in per_type_summary(rows):
        print(f"{t['op']:<20} {t['ms']:8.4f} ms  ({t['rows']} ops)")
    print("wrote", out_path)


if __name__ == "__main__":
    _main()
