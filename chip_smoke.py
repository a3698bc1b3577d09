"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json PATH]

Run from the root of the repository on a machine with one CUDA card (an
H100: the kernels are built for sm_90a).  It imports only
``paddle_lite_tpu_torch`` (never jax or the JAX package) and exits non-zero,
printing no result, if any phase fails or no card is present.

Phases:
1. Device: the card's name and power limit, torch / CUDA versions, the
   kernels' build (one nvcc per source, started together) and its time.
2. Kernels against their plain PyTorch versions on the card, at every shape
   the main path gives them (MobileNetV1, batch 64, 224 px), plus a k=5
   case and ragged cases: the int32 accumulators and the int8 outputs must
   match exactly (0 differing elements).  Each shape is timed with CUDA
   events around CUDA-graph replays of one call (median of 25, after
   warm-up; "eager" repeats it without the graph, dispatch time included),
   beside its plain version, one PyTorch library call computing the same
   product (a yardstick the port never calls), and its bound: the larger of
   bytes / 3.35 TB/s and operations / peak (1,979 int8 tensor-core TOP/s
   for the GEMM; for the depthwise kernel, which does fp32 FMAs, SMs x 128
   FMA/clk x the max SM clock nvidia-smi reports).
3. The main path end to end at full width: ``mobilenet_v1.build`` →
   ``create_predictor(quant=QuantConfig(), calib_batches=..., device="cuda")``
   → 3 requests.  The launch counters must show 14 GEMM and 13 depthwise
   launches a request; the int8 output must reach cosine > 0.99 against the
   port's fp32 predictor; TF32 must be off while the fp32 predictor runs;
   against the same graph with the plain ``"torch"`` ops on the card, every
   kernel op fed identical inputs must agree up to rounding ties and the
   softmax output within 1e-3 (``paddle_lite_tpu_torch/testing.py``).
   img/s for fp32 and int8, and a profiled request, are information.
4. SSD-MobileNetV1-300 INT8 at batch 32, 21 classes (``ssd.build`` →
   ``create_predictor(quant=QuantConfig(), ...)``).  First the kernels at
   this path's shapes: the GEMM and depthwise kernels as in phase 2, and
   the NMS kernel on the path's own candidates (G = 32·21 = 672 instances
   of k = 528, the bucket3@176 tier) and on edge cases (ties, unsorted and
   sorted input, all-invalid instances, identical boxes, k = 400, 33, 1
   and 1024), bit-exact against its plain version; its bound is the larger
   of bytes / 3.35 TB/s and 13 fp32 operations for each pair of valid
   candidates (counted on this run's scores) / (2 x the FMA rate above).  Then 3 requests: exactly
   17 GEMM, 13 depthwise and 1 NMS launch a request; every kernel op except
   ``multiclass_nms`` against its torch op on identical inputs (tie bound);
   ``multiclass_nms`` with the kernel against the same op with the plain
   version, exactly.  int8 vs fp32 detections, the largest int8
   accumulator of the torch-path 3x3 convs, img/s and a profiled request
   are information.
5. The last lines: the card (nvidia-smi), the kernels' JSON line, then
   ``{"ok": true, "device": {...}}``.

With ``--json PATH`` the per-shape numbers are also written to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, SIZE = 64, 224
SSD_BATCH, SSD_SIZE, SSD_CLASSES = 32, 300, 21
DEV = torch.device("cuda")
REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12


def fail(msg: str) -> None:
    print(f"CHIP_SMOKE FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvsmi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _median_ms(call, reps: int) -> float:
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        call()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of `fn`: CUDA events around each of
    `reps` replays of a CUDA graph holding the call, so the host's dispatch
    time between launches is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    return _median_ms(graph.replay, reps)


def eager_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median time of one eager call of `fn` by CUDA events around it: the
    device time, or the host's dispatch time where that is longer."""
    for _ in range(warmup):
        fn()
    return _median_ms(fn, reps)


def bound(nbytes: float, ops_s: float) -> dict:
    b_ms, o_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops_s
    return {"bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


# ---- phase 1 ---------------------------------------------------------------

def phase_device():
    from paddle_lite_tpu_torch.core.device import fp32_exact
    from paddle_lite_tpu_torch.ops.kernels import _build

    card = nvsmi("name,power.limit")
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
          f"({ {k: round(v, 1) for k, v in secs.items()} })")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    with fp32_exact():
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            fail("TF32 still on inside fp32_exact()")
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(nvsmi("clocks.max.sm").split()[0])
    fma_per_s = props.multi_processor_count * 128 * clock_mhz * 1e6
    print(f"SMs {props.multi_processor_count}, max SM clock {clock_mhz} MHz "
          f"-> fp32 FMA rate {fma_per_s:.4g}/s")
    return card, fma_per_s


# ---- phase 2 ---------------------------------------------------------------

def main_path_shapes():
    """(M, K, N) of every GEMM call and (N, H, W, C, k, s) of every
    depthwise call in one request, read off the model's graph."""
    from paddle_lite_tpu_torch.models import mobilenet_v1

    g = mobilenet_v1.build(batch=BATCH, image_size=SIZE, seed=0)
    gemm, dw = [], []
    for op in g.topological_order():
        if op.op_type == "depthwise_conv2d":
            n, h, w, c = g.vars[op.input("Input")].shape
            k = g.vars[op.input("Filter")].shape[0]
            dw.append((n, h, w, c, k, int(op.attrs["strides"][0])))
        elif op.op_type == "conv2d" and g.vars[op.input("Filter")].shape[:2] == (1, 1):
            n, h, w, c = g.vars[op.input("Input")].shape
            gemm.append((n * h * w, c, g.vars[op.input("Filter")].shape[3], True))
        elif op.op_type == "fc":
            k, n = g.vars[op.input("W")].shape
            gemm.append((BATCH, k, n, False))  # classifier: fp32 out
    return gemm, dw


def _cuda_rand_int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, size=shape, dtype=np.int8)).to(DEV)


def _cmp(a: torch.Tensor, b: torch.Tensor):
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    return int((d > 0).sum()), float(d.max()) if d.numel() else 0.0


def check_gemm(rng, m, k, n, int8_out: bool, timed: bool):
    from paddle_lite_tpu_torch.ops.kernels import int8_matmul as km

    x = _cuda_rand_int8(rng, (m, k))
    w = _cuda_rand_int8(rng, (k, n))
    w_nk = w.t().contiguous()
    eff = torch.from_numpy(rng.uniform(1e-4, 2e-4, n).astype(np.float32)).to(DEV)
    bias = torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(DEV)
    ones = torch.ones(n, device=DEV)
    # int32 accumulators: unit scale, no bias, fp32 out (exact below 2^24)
    acc_k = km.int8_matmul(x, w, ones, w_nk=w_nk)
    acc_p = km.int8_matmul_plain(x, w, ones)
    bad_acc, _ = _cmp(acc_k, acc_p)
    y = km.int8_matmul_plain(x, w, eff, bias, act="relu")
    out_scale = float(y.abs().max()) / 127 * 0.75 if int8_out else None
    kw = dict(act="relu", out_scale=out_scale)
    got = km.int8_matmul(x, w, eff, bias, w_nk=w_nk, **kw)
    ref = km.int8_matmul_plain(x, w, eff, bias, **kw)
    bad, err = _cmp(got, ref)
    row = {"kernel": "int8_gemm", "shape": [m, k, n],
           "out": "int8" if int8_out else "fp32",
           "acc_mismatch": bad_acc, "out_mismatch": bad, "max_abs_err": err}
    if timed:
        row["ms"] = time_ms(lambda: km.int8_matmul(x, w, eff, bias, w_nk=w_nk, **kw))
        row["eager_ms"] = eager_ms(lambda: km.int8_matmul(x, w, eff, bias, w_nk=w_nk, **kw))
        row["plain_ms"] = time_ms(lambda: km.int8_matmul_plain(x, w, eff, bias, **kw))
        row["library_ms"] = (time_ms(lambda: torch._int_mm(x, w))
                             if m > 16 and k % 8 == 0 and n % 8 == 0 else None)
        nbytes = m * k + k * n + m * n * (1 if int8_out else 4) + 8 * n
        row.update(bound(nbytes, 2 * m * k * n / INT8_TC_OPS_PER_S))
    return row


def check_dw(rng, shape, int8_out: bool, timed: bool, fma_per_s: float,
             entry: str = "dw_conv_int8"):
    import torch.nn.functional as F

    from paddle_lite_tpu_torch.ops.kernels import depthwise as kd

    n, h, wd, c, k, s = shape
    x = _cuda_rand_int8(rng, (n, h, wd, c))
    w = _cuda_rand_int8(rng, (k, k, 1, c))
    eff = torch.from_numpy(rng.uniform(1e-3, 2e-3, c).astype(np.float32)).to(DEV)
    bias = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)).to(DEV)
    ones = torch.ones(c, device=DEV)
    if entry == "dw_conv3x3s1_int8":
        def kern(*a, **kw):
            return kd.dw_conv3x3s1_int8(*a, **kw)
    else:
        def kern(*a, **kw):
            return kd.dw_conv_int8(*a, stride=s, **kw)
    acc_k = kern(x, w, ones)
    acc_p = kd.dw_conv_int8_plain(x, w, ones, stride=s)
    bad_acc, _ = _cmp(acc_k, acc_p)
    y = kd.dw_conv_int8_plain(x, w, eff, bias, stride=s, act="relu")
    out_scale = float(y.abs().max()) / 127 * 0.75 if int8_out else None
    kw = dict(act="relu", out_scale=out_scale)
    got = kern(x, w, eff, bias, **kw)
    ref = kd.dw_conv_int8_plain(x, w, eff, bias, stride=s, **kw)
    bad, err = _cmp(got, ref)
    row = {"kernel": "dw_conv", "entry": entry, "shape": list(shape),
           "out": "int8" if int8_out else "fp32",
           "acc_mismatch": bad_acc, "out_mismatch": bad, "max_abs_err": err}
    if timed:
        row["ms"] = time_ms(lambda: kern(x, w, eff, bias, **kw))
        row["eager_ms"] = eager_ms(lambda: kern(x, w, eff, bias, **kw))
        row["plain_ms"] = time_ms(
            lambda: kd.dw_conv_int8_plain(x, w, eff, bias, stride=s, **kw))
        xf = x.permute(0, 3, 1, 2).float().contiguous(memory_format=torch.channels_last)
        wf = w.permute(3, 2, 0, 1).float().contiguous()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            row["library_ms"] = time_ms(
                lambda: F.conv2d(xf, wf, stride=s, padding=(k - 1) // 2, groups=c))
        oh, ow = kd.out_size(h, k, s), kd.out_size(wd, k, s)
        nbytes = n * h * wd * c + k * k * c + n * oh * ow * c * (1 if int8_out else 4) + 8 * c
        row.update(bound(nbytes, n * oh * ow * c * k * k / fma_per_s))
    return row


def phase_kernels(fma_per_s: float):
    rng = np.random.default_rng(0)
    gemm, dw = main_path_shapes()
    rows = []
    seen = {}
    for m, k, n, int8_out in gemm:
        key = ("gemm", m, k, n, int8_out)
        if key not in seen:
            seen[key] = check_gemm(rng, m, k, n, int8_out, timed=True)
            seen[key].update(per_request=0, path="mobilenet_v1")
            rows.append(seen[key])
        seen[key]["per_request"] += 1
    # the fc with int8 out too, and ragged GEMMs (M, N, K off the tiles)
    rows.append(check_gemm(rng, BATCH, 1024, 1000, True, timed=False))
    rows.append(check_gemm(rng, 1000, 96, 200, True, timed=False))
    rows.append(check_gemm(rng, 333, 40, 70, False, timed=False))
    for shape in dw:
        key = ("dw",) + shape
        if key not in seen:
            seen[key] = check_dw(rng, shape, True, True, fma_per_s)
            seen[key].update(per_request=0, path="mobilenet_v1")
            rows.append(seen[key])
        seen[key]["per_request"] += 1
    extra = [((BATCH, 56, 56, 128, 3, 1), True, "dw_conv3x3s1_int8"),
             ((8, 28, 28, 96, 5, 1), True, "dw_conv_int8"),
             ((8, 27, 27, 96, 5, 2), False, "dw_conv_int8"),
             ((4, 19, 23, 30, 3, 2), True, "dw_conv_int8"),    # C % 4 != 0
             ((4, 17, 13, 37, 3, 1), False, "dw_conv_int8")]
    for shape, int8_out, entry in extra:
        rows.append(check_dw(rng, shape, int8_out, entry == "dw_conv3x3s1_int8",
                             fma_per_s, entry))
    print("phase 2: kernel vs plain version (ms: device time, CUDA-graph "
          "replays, median of 25; eager: the same without the graph)")
    _report_rows(rows)
    return rows


def _report_rows(rows):
    for r in rows:
        lib = r.get("library_ms")
        t = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} eager {r['eager_ms']:.4f} plain {r['plain_ms']:.4f} "
            f"lib {lib if lib is None else round(lib, 4)} "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']}) x{r.get('per_request', 0)}")
        print(f"  {r['kernel']:9s} {str(r['shape']):28s} {r['out']:4s} "
              f"acc_mismatch {r['acc_mismatch']} out_mismatch {r['out_mismatch']}{t}")
    for s in (1, 2):  # the depthwise kernel's time per request, by stride
        mine = [r for r in rows if r["kernel"] == "dw_conv"
                and r.get("per_request") and r["shape"][5] == s]
        sums = {k: sum(r[k] * r["per_request"] for r in mine)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"  dw_conv stride {s}: {sum(r['per_request'] for r in mine)} "
              f"launches a request, " + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()))
    bad = [r for r in rows if r["acc_mismatch"] or r["out_mismatch"]]
    if bad:
        fail(f"{len(bad)} kernel checks disagree with the plain version: {bad}")


# ---- phase 3 ---------------------------------------------------------------

def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def _ips(pred, feed, reps: int = 10, batch: int = BATCH) -> float:
    pred.run(feed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.run(feed)
    torch.cuda.synchronize()
    return reps * batch / (time.perf_counter() - t0)


def _device_breakdown(pred, feed, top: int = 8) -> dict:
    """One request under torch.profiler: host wall time, summed device
    kernel time, and the kernels that take most of it (information)."""
    from torch.profiler import ProfilerActivity, profile

    pred.run(feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.run(feed)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op also reports its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return {"wall_ms": wall_ms, "device_ms": sum(r[0] for r in rows),
            "top": [{"ms": r[0], "count": r[1], "name": r[2][:80]}
                    for r in rows[:top]]}


def phase_main_path():
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.core.executor import build_callable
    from paddle_lite_tpu_torch.models import mobilenet_v1
    from paddle_lite_tpu_torch.ops.kernels import depthwise, int8_matmul
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor
    from paddle_lite_tpu_torch.testing import (SOFTMAX_ATOL, TIE_FRACTION,
                                               TIE_LSB, capture_all,
                                               op_local_diffs, retag,
                                               within_tie_bound)

    rng = np.random.default_rng(0)
    shape = (BATCH, SIZE, SIZE, 3)
    calib = [{"image": rng.normal(size=shape).astype(np.float32)}]
    feeds = [{"image": rng.normal(size=shape).astype(np.float32)}
             for _ in range(REQUESTS)]

    t0 = time.perf_counter()
    g8 = mobilenet_v1.build(batch=BATCH, image_size=SIZE, seed=0)
    pred8 = create_predictor(g8, quant=QuantConfig(), calib_batches=calib,
                             device=DEV)
    pred32 = create_predictor(mobilenet_v1.build(batch=BATCH, image_size=SIZE,
                                                 seed=0), device=DEV)
    print(f"phase 3: build + optimize + calibrate {time.perf_counter() - t0:.1f} s")
    tags = [op.attrs.get("kernel") for op in g8.ops]
    print(f"  ops {len(g8.ops)}, kernel='cuda' on {tags.count('cuda')}")

    int8_matmul.launches = 0
    depthwise.launches = 0
    depthwise.launches_by_stride = {1: 0, 2: 0}
    outs = [pred8.run(f) for f in feeds]
    torch.cuda.synchronize()
    launches = {"int8_gemm": int8_matmul.launches, "dw_conv": depthwise.launches}
    print(f"  launches over {REQUESTS} requests: {launches}")
    launches.update(dw_conv_s1=depthwise.launches_by_stride[1],
                    dw_conv_s2=depthwise.launches_by_stride[2])
    if (launches["int8_gemm"], launches["dw_conv"]) != (14 * REQUESTS, 13 * REQUESTS):
        fail(f"expected 14 GEMM and 13 depthwise launches a request, "
             f"got {launches} over {REQUESTS} requests")

    out_name = g8.outputs[0]
    for i, (f, o) in enumerate(zip(feeds, outs)):
        y = o[out_name]
        if tuple(y.shape) != (BATCH, 1000) or not bool(torch.isfinite(y).all()):
            fail(f"request {i}: output {tuple(y.shape)} not finite (b, 1000)")
        cos = _cosine(y, pred32.run(f)[out_name])
        print(f"  request {i}: int8 vs fp32 cosine {cos:.6f}")
        if not cos > 0.99:
            fail(f"request {i}: int8 vs fp32 cosine {cos} <= 0.99")

    # TF32 stays off on the fp32 path while a predictor runs
    def tf32_off(name, val):
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            fail(f"TF32 is on while {name} is computed")

    build_callable(pred32.graph, device=DEV, capture=tf32_off)(
        pred32._weights, feeds[0])

    # the same optimized graph with the plain torch ops, on the card: every
    # kernel op against its torch op on identical inputs (tie bound), and
    # the softmax output end to end
    local = op_local_diffs(g8, pred8._weights, feeds[0], DEV)
    n_ops_diff = sum(1 for d in local if d["n_diff"])
    worst_frac = max(d["n_diff"] / d["numel"] for d in local)
    worst_lsb = max(d["max_diff"] for d in local)
    print(f"  cuda vs torch op by op: {len(local)} outputs, {n_ops_diff} with "
          f"any difference, worst fraction {worst_frac:.3g}, worst {worst_lsb} "
          f"(bound: {TIE_FRACTION} of elements, {TIE_LSB} LSB)")
    if not within_tie_bound(local):
        fail(f"a kernel disagrees with its torch op beyond the tie bound: "
             f"{[d for d in local if d['n_diff']]}")
    env_k = capture_all(g8, pred8._weights, feeds[0], DEV)
    env_t = capture_all(retag(g8, "cuda", "torch"), pred8._weights, feeds[0], DEV)
    e2e_frac = max(float((env_k[n] != env_t[n]).float().mean())
                   for n in env_k if env_k[n].dtype == torch.int8)
    sm_err = float((env_k[out_name] - env_t[out_name]).abs().max())
    top1 = float((env_k[out_name].argmax(-1) == env_t[out_name].argmax(-1))
                 .float().mean())
    print(f"  cuda vs torch end to end: worst int8 tensor differs in "
          f"{e2e_frac:.3g} of elements (ties spread), softmax max abs diff "
          f"{sm_err:.3g} (bound {SOFTMAX_ATOL}), top-1 agreement {top1}")
    if sm_err > SOFTMAX_ATOL:
        fail(f"softmax differs by {sm_err} between cuda and torch tags")
    del env_k, env_t

    ips8, ips32 = _ips(pred8, feeds[0]), _ips(pred32, feeds[0])
    on_dev = {"image": torch.from_numpy(feeds[0]["image"]).to(DEV)}
    ips8_d, ips32_d = _ips(pred8, on_dev), _ips(pred32, on_dev)
    print(f"  img/s at b{BATCH} (host clock, 10 requests; numpy input / input "
          f"already on the card): int8 {ips8:.1f} / {ips8_d:.1f}, fp32 "
          f"{ips32:.1f} / {ips32_d:.1f}")
    prof = {}
    for tag, pred in (("int8", pred8), ("fp32", pred32)):
        prof[tag] = p = _device_breakdown(pred, on_dev)
        print(f"  {tag} request under the profiler (input on the card): wall "
              f"{p['wall_ms']:.3f} ms, device kernels {p['device_ms']:.3f} ms")
        for r in p["top"]:
            print(f"    {r['ms']:.4f} ms x{r['count']} {r['name']}")
    return launches, {"int8_img_s": ips8, "fp32_img_s": ips32,
                      "int8_img_s_input_on_card": ips8_d,
                      "fp32_img_s_input_on_card": ips32_d, "profile": prof,
                      "op_local_worst_fraction": worst_frac,
                      "op_local_worst_lsb": worst_lsb,
                      "op_local_outputs_with_diff": n_ops_diff,
                      "e2e_worst_int8_fraction": e2e_frac,
                      "softmax_max_abs_diff": sm_err, "top1_agreement": top1}


# ---- phase 4 ---------------------------------------------------------------

NMS_OPS_PER_PAIR = 13  # csrc/nms.cu: 2 min, 4 max, 3 sub, 2 mul, 1 add, 1 compare


def kernel_shapes(g):
    """(M, K, N, int8 out) of every GEMM op and ((N, H, W, C, k, s), int8
    out) of every depthwise op that the optimized graph `g` tags "cuda"."""
    gemm, dw = [], []
    for op in g.topological_order():
        if op.attrs.get("kernel") != "cuda":
            continue
        int8_out = op.attrs.get("out_scale") is not None
        if op.op_type in ("conv2d", "depthwise_conv2d"):
            n, h, w, c = g.vars[op.input("Input")].shape
            kh, _, _, oc = g.vars[op.input("Filter")].shape
            if op.op_type == "conv2d":
                gemm.append((n * h * w, c, oc, int8_out))
            else:
                dw.append(((n, h, w, c, kh, int(op.attrs["strides"][0])), int8_out))
    return gemm, dw


def check_nms(case, boxes, scores, iou_t, score_t, fp32_ops_per_s, timed):
    from paddle_lite_tpu_torch.ops.kernels import nms as kn

    g, k = scores.shape
    kw = dict(iou_t=iou_t, score_t=score_t)
    got = kn.nms_keep_scores(boxes, scores, **kw)
    ref = kn.nms_keep_scores_plain(boxes, scores, **kw)
    bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
    row = {"kernel": "nms", "case": case, "shape": [g, k], "out": "fp32",
           "acc_mismatch": 0, "out_mismatch": bad,
           "max_abs_err": float((got - ref).abs().max()),
           "kept": int((got > 0).sum()),
           "valid": int((scores > float(np.float32(score_t))).sum())}
    if timed:
        row["ms"] = time_ms(lambda: kn.nms_keep_scores(boxes, scores, **kw))
        row["eager_ms"] = eager_ms(lambda: kn.nms_keep_scores(boxes, scores, **kw))
        # the plain version syncs on every Jacobi round: no CUDA graph
        row["plain_ms"] = eager_ms(lambda: kn.nms_keep_scores_plain(boxes, scores, **kw),
                                   reps=5, warmup=1)
        row["library_ms"] = None  # no one PyTorch call computes greedy NMS
        nv = (scores > float(np.float32(score_t))).sum(dim=1).double()
        pairs = float((nv * (nv - 1) / 2).sum())  # pairs of valid candidates
        row["pair_tests"] = pairs
        row.update(bound(24.0 * g * k, NMS_OPS_PER_PAIR * pairs / fp32_ops_per_s))
    return row


def nms_edge_cases(rng):
    """(case, boxes, scores) on the card: ties, unsorted and sorted input,
    all-invalid instances, identical boxes, and k off the 32-bit words."""
    def cand(g, k):
        c = rng.uniform(0.1, 0.9, (g, k, 2))
        wh = rng.uniform(0.02, 0.35, (g, k, 2))
        b = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        sc = rng.uniform(0, 1, (g, k)).astype(np.float32)
        sc[:, ::3] *= 0.005
        return b, sc

    cases = []
    b, sc = cand(64, 528)
    sc[:, 40:80] = sc[:, 7:8]
    cases.append(("ties_unsorted", b, sc))
    b, sc = cand(16, 528)
    cases.append(("sorted", b, -np.sort(-sc, axis=1)))
    b, sc = cand(16, 528)
    sc[::2] = 0.004
    cases.append(("all_invalid_every_other", b, sc))
    b, sc = cand(8, 528)
    b[:, 100:300] = b[:, 100:101]
    sc[:, 150:250] = 0.7
    cases.append(("identical_boxes_and_ties", b, sc))
    for g, k in ((672, 400), (5, 33), (3, 1), (4, 1024)):
        b, sc = cand(g, k)
        cases.append((f"k{k}", b, sc))
    return [(name, torch.from_numpy(b).to(DEV), torch.from_numpy(sc).to(DEV))
            for name, b, sc in cases]


def _area(r: torch.Tensor) -> torch.Tensor:
    return (r[:, 4] - r[:, 2]).clamp(min=0) * (r[:, 5] - r[:, 3]).clamp(min=0)


def _det_agreement(a: torch.Tensor, b: torch.Tensor, iou_min: float = 0.5) -> float:
    """Share of a's detections (label >= 0) that b has in the same image:
    same label and IoU >= iou_min."""
    a, b = a.double().cpu(), b.double().cpu()
    hit = tot = 0
    for ra, rb in zip(a, b):
        ra, rb = ra[ra[:, 0] >= 0], rb[rb[:, 0] >= 0]
        tot += len(ra)
        if not len(ra) or not len(rb):
            continue
        lt = torch.maximum(ra[:, None, 2:4], rb[None, :, 2:4])
        rt = torch.minimum(ra[:, None, 4:6], rb[None, :, 4:6])
        inter = (rt - lt).clamp(min=0).prod(-1)
        iou = inter / (_area(ra)[:, None] + _area(rb)[None, :] - inter).clamp(min=1e-12)
        same = ra[:, None, 0] == rb[None, :, 0]
        hit += int(((iou >= iou_min) & same).any(dim=1).sum())
    return hit / max(tot, 1)


def _torch_conv_acc(g, env, weights) -> dict:
    """The int8 3x3 convs left on the torch path (an fp32 conv, exact while
    every partial sum stays below 2^24): the largest |accumulator| over
    this request, and the largest sum of |x·w| (a bound on any partial sum
    in any order), in float64."""
    from paddle_lite_tpu_torch.ops.common import normalize_2d, normalize_paddings
    from paddle_lite_tpu_torch.ops.nn import conv_nhwc

    worst = {"max_abs_acc": 0.0, "max_sum_abs": 0.0, "op": None, "n_ops": 0}
    for op in g.topological_order():
        if not (op.op_type == "conv2d" and op.attrs.get("enable_int8")
                and op.attrs.get("kernel") is None):
            continue
        x = env[op.input("Input")].to(torch.float64)
        w = weights[op.input("Filter")].to(torch.float64).permute(3, 2, 0, 1).contiguous()
        args = (normalize_2d(op.attrs.get("strides", (1, 1))),
                normalize_paddings(op.attrs.get("paddings", (0, 0))),
                normalize_2d(op.attrs.get("dilations", (1, 1))), 1)
        acc = float(conv_nhwc(x, w, *args).abs().max())
        sab = float(conv_nhwc(x.abs(), w.abs(), *args).max())
        worst["n_ops"] += 1
        if sab > worst["max_sum_abs"]:
            worst.update(max_sum_abs=sab, op=op.outputs["Output"][0],
                         k=int(w.shape[1] * w.shape[2] * w.shape[3]))
        worst["max_abs_acc"] = max(worst["max_abs_acc"], acc)
    return worst


def phase_ssd(fma_per_s: float):
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.models import ssd
    from paddle_lite_tpu_torch.ops.detection import exact_candidates
    from paddle_lite_tpu_torch.ops.kernels import depthwise, int8_matmul, nms, ops_cuda
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor
    from paddle_lite_tpu_torch.testing import (TIE_FRACTION, TIE_LSB, capture_all,
                                               op_local_diffs, within_tie_bound)

    rng = np.random.default_rng(1)
    shape = (SSD_BATCH, SSD_SIZE, SSD_SIZE, 3)
    calib = [{"image": rng.normal(size=shape).astype(np.float32)}]
    feeds = [{"image": rng.normal(size=shape).astype(np.float32)}
             for _ in range(REQUESTS)]
    kw = dict(batch=SSD_BATCH, image_size=SSD_SIZE, num_classes=SSD_CLASSES, seed=0)
    t0 = time.perf_counter()
    g8 = ssd.build(**kw)
    pred8 = create_predictor(g8, quant=QuantConfig(), calib_batches=calib, device=DEV)
    pred32 = create_predictor(ssd.build(**kw), device=DEV)
    print(f"phase 4: SSD-MobileNetV1 {SSD_SIZE} px, b{SSD_BATCH}, {SSD_CLASSES} "
          f"classes: build + optimize + calibrate {time.perf_counter() - t0:.1f} s")
    tags = {}
    for op in g8.ops:
        if op.attrs.get("kernel") == "cuda":
            tags[op.op_type] = tags.get(op.op_type, 0) + 1
    print(f"  ops {len(g8.ops)}, kernel='cuda': {tags}")
    nms_op = next(op for op in g8.ops if op.op_type == "multiclass_nms")
    box_name, score_name = nms_op.input("BBoxes"), nms_op.input("Scores")
    out_name = g8.outputs[0]
    attrs = nms_op.attrs
    iou_t, score_t = float(attrs["nms_threshold"]), float(attrs["score_threshold"])

    # (a) the kernels at this path's shapes, against their plain versions
    gemm, dw = kernel_shapes(g8)
    rows, seen = [], {}
    for m, k, n, int8_out in gemm:
        key = ("gemm", m, k, n, int8_out)
        if key not in seen:
            seen[key] = check_gemm(rng, m, k, n, int8_out, timed=True)
            seen[key].update(per_request=0, path="ssd")
            rows.append(seen[key])
        seen[key]["per_request"] += 1
    for shp, int8_out in dw:
        key = ("dw",) + shp + (int8_out,)
        if key not in seen:
            seen[key] = check_dw(rng, shp, int8_out, True, fma_per_s)
            seen[key].update(per_request=0, path="ssd")
            rows.append(seen[key])
        seen[key]["per_request"] += 1
    env = capture_all(g8, pred8._weights, feeds[0], DEV)
    boxes, scores = env[box_name], env[score_name]
    top_s, cand = ops_cuda.select_candidates(boxes, scores, attrs)
    n, c, k = top_s.shape
    fp32_ops = 2 * fma_per_s
    main = check_nms("ssd_bucket3", cand.reshape(n * c, k, 4).contiguous(),
                     top_s.reshape(n * c, k).contiguous(), iou_t, score_t,
                     fp32_ops, timed=True)
    main.update(per_request=1, path="ssd")
    rows.append(main)
    top_e, cand_e = exact_candidates(boxes, scores, min(int(attrs["nms_top_k"]),
                                                        scores.shape[1]))
    ke = top_e.shape[-1]
    rows.append(check_nms("ssd_exact_tier", cand_e.reshape(n * c, ke, 4).contiguous(),
                          top_e.reshape(n * c, ke).contiguous(), iou_t, score_t,
                          fp32_ops, timed=False))
    for case, b, sc in nms_edge_cases(rng):
        rows.append(check_nms(case, b, sc, iou_t, score_t, fp32_ops, timed=False))
    print(f"  kernels at this path's shapes (NMS: G = {n * c} instances of k = {k}, "
          f"{main['valid']} valid candidates, {main['pair_tests']:.6g} pair tests)")
    _report_rows(rows)
    for r in rows:
        if r["kernel"] == "nms":
            print(f"    nms {r['case']}: {r['shape']} kept {r['kept']} of "
                  f"{r['valid']} valid, out_mismatch {r['out_mismatch']}")

    # (b) the path: 3 requests through the predictor
    int8_matmul.launches = 0
    depthwise.launches = 0
    depthwise.launches_by_stride = {1: 0, 2: 0}
    nms.launches = 0
    outs = [pred8.run(f) for f in feeds]
    torch.cuda.synchronize()
    launches = {"int8_gemm": int8_matmul.launches, "dw_conv": depthwise.launches,
                "dw_conv_s1": depthwise.launches_by_stride[1],
                "dw_conv_s2": depthwise.launches_by_stride[2], "nms": nms.launches}
    print(f"  launches over {REQUESTS} requests: {launches}")
    n_s1 = sum(1 for shp, _ in dw if shp[5] == 1)
    want = {"int8_gemm": 17, "dw_conv": 13, "dw_conv_s1": n_s1,
            "dw_conv_s2": 13 - n_s1, "nms": 1}
    if launches != {key: v * REQUESTS for key, v in want.items()}:
        fail(f"expected {want} launches a request, got {launches} over "
             f"{REQUESTS} requests")
    for i, o in enumerate(outs):
        y = o[out_name]
        lab = y[..., 0]
        if (tuple(y.shape) != (SSD_BATCH, 100, 6) or not bool(torch.isfinite(y).all())
                or not bool(((lab == -1) | ((lab >= 1) & (lab < SSD_CLASSES))).all())):
            fail(f"request {i}: output {tuple(y.shape)} is not finite "
                 f"(b, 100, 6) rows with labels in -1 or 1..{SSD_CLASSES - 1}")
    n_det = int((outs[0][out_name][..., 0] >= 0).sum())
    if not torch.equal(outs[0][out_name], env[out_name]):
        fail("the predictor's request and the captured run of the same input differ")

    # (c) kernel ops against torch ops on identical inputs; NMS against its
    # own impl with the plain version
    local = op_local_diffs(g8, pred8._weights, feeds[0], DEV)  # skips NMS
    n_ops_diff = sum(1 for d in local if d["n_diff"])
    worst_frac = max(d["n_diff"] / d["numel"] for d in local)
    worst_lsb = max(d["max_diff"] for d in local)
    print(f"  cuda vs torch op by op (all but multiclass_nms): {len(local)} outputs, "
          f"{n_ops_diff} with any difference, worst fraction {worst_frac:.3g}, worst "
          f"{worst_lsb} (bound: {TIE_FRACTION} of elements, {TIE_LSB} LSB)")
    if len(local) != 30 or not within_tie_bound(local):
        fail(f"a kernel disagrees with its torch op beyond the tie bound: "
             f"{[d for d in local if d['n_diff']]}")
    got = ops_cuda.multiclass_nms(boxes, scores, attrs)
    ref = ops_cuda.multiclass_nms(boxes, scores, attrs, keep=nms.nms_keep_scores_plain)
    nms_equal = torch.equal(got, ref) and torch.equal(got, env[out_name])
    print(f"  multiclass_nms, NMS kernel vs plain version on the same inputs: "
          f"{'equal' if nms_equal else 'DIFFERENT'} ({n_det} detections in "
          f"{SSD_BATCH} images)")
    if not nms_equal:
        fail("multiclass_nms with the kernel differs from it with the plain version")

    # (d) information: int8 vs fp32 detections, the torch-path accumulators
    det32 = pred32.run(feeds[0])[out_name]
    agree = (_det_agreement(env[out_name], det32), _det_agreement(det32, env[out_name]))
    print(f"  int8 vs fp32 detections (same label, IoU >= 0.5, same image): "
          f"{agree[0]:.4f} of int8's found in fp32, {agree[1]:.4f} of fp32's in int8")
    acc = _torch_conv_acc(g8, env, pred8._weights)
    print(f"  int8 3x3 convs on the torch path ({acc['n_ops']}): largest |acc| "
          f"{acc['max_abs_acc']:.6g}, largest sum |x·w| {acc['max_sum_abs']:.6g} "
          f"(at {acc['op']}, K = {acc.get('k')}); exact below 2^24 = {2**24}: "
          f"{acc['max_sum_abs'] < 2**24}")
    del env, local

    # (e) information: throughput and where a request's time goes
    on_dev = {"image": torch.from_numpy(feeds[0]["image"]).to(DEV)}
    ips8 = _ips(pred8, feeds[0], batch=SSD_BATCH)
    ips8_d = _ips(pred8, on_dev, batch=SSD_BATCH)
    ips32 = _ips(pred32, feeds[0], batch=SSD_BATCH)
    ips32_d = _ips(pred32, on_dev, batch=SSD_BATCH)
    print(f"  img/s at b{SSD_BATCH} (host clock, 10 requests; numpy input / input "
          f"already on the card): int8 {ips8:.1f} / {ips8_d:.1f}, fp32 "
          f"{ips32:.1f} / {ips32_d:.1f}")
    prof = {}
    for tag, pred in (("int8", pred8), ("fp32", pred32)):
        prof[tag] = p = _device_breakdown(pred, on_dev, top=12)
        print(f"  {tag} request under the profiler (input on the card): wall "
              f"{p['wall_ms']:.3f} ms, device kernels {p['device_ms']:.3f} ms")
        for r in p["top"]:
            print(f"    {r['ms']:.4f} ms x{r['count']} {r['name']}")
    return rows, launches, {
        "int8_img_s": ips8, "fp32_img_s": ips32, "int8_img_s_input_on_card": ips8_d,
        "fp32_img_s_input_on_card": ips32_d, "profile": prof,
        "op_local_worst_fraction": worst_frac, "op_local_worst_lsb": worst_lsb,
        "op_local_outputs_with_diff": n_ops_diff, "detections": n_det,
        "int8_in_fp32_agreement": agree[0], "fp32_in_int8_agreement": agree[1],
        "torch_conv_acc": acc}


# ---- the kernels' line -----------------------------------------------------

KERNELS = [  # name, source, TPU kernel it replaces, rows it covers
    ("int8_gemm", "paddle_lite_tpu_torch/csrc/int8_gemm.cu",
     "paddle_lite_tpu/ops/kernels/int8_matmul.py:122",
     lambda r: r["kernel"] == "int8_gemm"),
    ("dw_conv_s1", "paddle_lite_tpu_torch/csrc/dw_conv.cu",
     "paddle_lite_tpu/ops/kernels/depthwise.py:293",
     lambda r: r["kernel"] == "dw_conv" and r["shape"][5] == 1),
    ("dw_conv_s2", "paddle_lite_tpu_torch/csrc/dw_conv.cu",
     "paddle_lite_tpu/ops/kernels/depthwise.py:334",
     lambda r: r["kernel"] == "dw_conv" and r["shape"][5] == 2),
    ("nms", "paddle_lite_tpu_torch/csrc/nms.cu",
     "paddle_lite_tpu/ops/kernels/nms.py:114",
     lambda r: r["kernel"] == "nms"),
]


def _kernel_line(rows, launches_by_path):
    """One entry per kernel: launches summed over the paths' runs; times
    and bounds summed over one request of every path."""
    out = []
    for name, src, replaces, covers in KERNELS:
        mine = [r for r in rows if covers(r)]
        timed = [r for r in mine if r.get("per_request")]

        def total(key):
            return sum(r[key] * r["per_request"] for r in timed)

        lib = [r["library_ms"] for r in timed]
        by_path = {p: n.get(name, 0) for p, n in launches_by_path.items()}
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                         else "operations"),
            "library_ms": None if any(v is None for v in lib) else total("library_ms"),
        })
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the per-shape numbers here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        import paddle_lite_tpu_torch  # noqa: F401  (fails outside the repo)
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if any(m == "jax" or m.startswith("jax.") or m == "paddle_lite_tpu"
           or m.startswith("paddle_lite_tpu.") for m in sys.modules):
        fail("jax or the JAX package was imported")

    card, fma_per_s = phase_device()
    rows = phase_kernels(fma_per_s)
    launches, e2e = phase_main_path()
    ssd_rows, ssd_launches, ssd = phase_ssd(fma_per_s)
    kernels = _kernel_line(rows + ssd_rows, {"mobilenet_v1": launches,
                                             "ssd": ssd_launches})
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows + ssd_rows, "main_path": e2e,
                       "ssd": ssd, "kernels": kernels}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
