"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json PATH]

Run from the root of the repository on a machine with one CUDA card (an
H100: the kernels are built for sm_90a).  It imports only
``paddle_lite_tpu_torch`` (never jax or the JAX package) and exits non-zero,
printing no result, if any phase fails or no card is present.

Phases:
1. Device: the card's name and power limit, torch / CUDA versions, the
   kernels' build (one nvcc per source, started together) and its time;
   no instantiation of any kernel may spill registers; the timing floor
   (a 16-element add timed as the kernels are).
2. Kernels against their plain PyTorch versions on the card, at every shape
   the main path gives them (MobileNetV1, batch 64, 224 px), plus a k=5
   case and ragged cases (for the depthwise kernel: H and W off its tiles,
   8-byte and byte copies, N = 1, C = 8, fp32 out with hard_swish and
   hard_sigmoid): the int32 accumulators and the int8 outputs must match
   exactly (0 differing elements).  Each shape is timed with CUDA events
   around CUDA-graph replays of one call (median of 25, after warm-up;
   "eager" repeats it without the graph, dispatch time included), beside
   its plain version, one PyTorch library call computing the same product
   (a yardstick the port never calls), and its bound: the larger of bytes
   / 3.35 TB/s and operations / peak (1,979 int8 tensor-core TOP/s for the
   GEMM; for the depthwise kernel, which does fp32 FMAs, SMs x 128 FMA/clk
   x the max SM clock nvidia-smi reports).  Each timed depthwise shape
   prints its tiling plan; each path's depthwise time a request prints
   beside its cuDNN time and bound, with their ratios (also in the kernels
   line, `by_path`).
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
   and 1024), bit-exact against its plain version, timed with one call
   and with ten calls a graph; its bound is the larger of bytes / 3.35
   TB/s and 13 fp32 operations for each pair that greedy NMS must test (a
   kept candidate against each valid one it beats, counted on this run's
   scores and output: a removed candidate suppresses nothing) / the fp32
   instruction rate (the FMA rate above: none of the 13 is an FMA),
   printed with its plan (shared bytes, blocks an SM, waves).  Then 3
   requests: exactly 17 GEMM, 13 depthwise and 1 NMS launch a request;
   every kernel op except ``multiclass_nms`` against its torch op on
   identical inputs (tie bound);
   ``multiclass_nms`` with the kernel against the same op with the plain
   version, exactly.  int8 vs fp32 detections, the largest int8
   accumulator of the torch-path 3x3 convs, img/s and a profiled request
   are information.
5. MobileNetV1 b64/224 with ``QuantConfig(fuse_dw_pw=True)``: the fused
   dw+pw kernel at the path's two shapes (timed with one call a graph and
   with ten, beside its bound, its plain version and the unfused pair of
   kernels read the same two ways; each shape prints its plan) and on
   ragged and edge shapes (W > 128, C % 4 != 0 and C = 8, 24, 40, 72, O >
   128 and odd O, O in chunks, H off the band, several sub-tiles a band,
   fp32 out, every activation), each bit-exact against its plain version
   and the unfused pair.  Then phase
   3's 3 requests: exactly 2 fused, 11 depthwise (7 at stride 1) and 12
   GEMM launches a request; the softmax equal to phase 3's; every fused op
   equal to the unfused kernels on its own inputs, the other kernel ops
   within the tie bound of their torch ops.  img/s (also in turns with
   phase 3's predictor) and a profiled request are information.
6. MobileNetV3-Large b64/224 INT8 (``with_softmax=False``): no int8 op
   that a kernel takes is left on the torch path; the GEMM and depthwise
   kernels at every shape and activation of the path (relu, hard_swish,
   hard_sigmoid, none) bit-exact against their plain versions; 3 requests
   with as many launches as the graph has "cuda" ops of each kind; every
   kernel op within the tie bound of its torch op; int8 logits against
   the fp32 predictor's, cosine > 0.96 (the bar of
   ``tests/test_model_zoo_int8.py:38``).  img/s and a profiled request
   are information.
7. The last lines: the card (nvidia-smi), the kernels' JSON line, then
   ``{"ok": true, "device": {...}}``.

With ``--json PATH`` the per-shape numbers are also written to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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


def time_ms(fn, reps: int = 25, warmup: int = 3, calls: int = 1) -> float:
    """Median device time of one call of `fn`: CUDA events around each of
    `reps` replays of a CUDA graph holding `calls` calls (the reading over
    `calls`), so the host's dispatch time between launches is not counted
    and, with several calls, the graph's launch floor is spread."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    return _median_ms(graph.replay, reps) / calls


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
    for name in _build.SOURCES:  # every instantiation of every source: one line
        log = _build.build_log(name)
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        advice = len(re.findall(r"Potential Performance Loss", log))
        print(f"  ptxas {name}: {len(regs)} instantiations, "
              f"{min(regs) if regs else '-'}-{max(regs) if regs else '-'} "
              f"registers a thread, {spills} bytes of spill stores and loads, "
              f"{advice} performance advisories")
        if spills or not regs:
            fail(f"{name} spills ({spills} bytes) or reported no instantiation")
    with fp32_exact():
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            fail("TF32 still on inside fp32_exact()")
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(nvsmi("clocks.max.sm").split()[0])
    fma_per_s = props.multi_processor_count * 128 * clock_mhz * 1e6
    print(f"SMs {props.multi_processor_count}, max SM clock {clock_mhz} MHz "
          f"-> fp32 FMA rate {fma_per_s:.4g}/s")
    from paddle_lite_tpu_torch.ops.kernels import depthwise as kd
    from paddle_lite_tpu_torch.ops.kernels import dw_pw_fused as kf
    for k in (3, 5):
        print(f"  dw_conv layout, k={k}: {kd.layout(k)}")
    print(f"  dw_pw_fused layout: {kf.layout()}")
    from paddle_lite_tpu_torch.ops.kernels import nms as kn
    print(f"  nms layout: {kn.layout()}")
    t = torch.zeros(16, device=DEV)
    print(f"timing floor: a 16-element add reads {time_ms(lambda: t.add_(1)):.4f} ms")
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


def check_gemm(rng, m, k, n, int8_out: bool, timed: bool, act: str = "relu",
               act_attrs: dict = None, eff_mul: float = 1.0):
    from paddle_lite_tpu_torch.ops.kernels import int8_matmul as km

    x = _cuda_rand_int8(rng, (m, k))
    w = _cuda_rand_int8(rng, (k, n))
    w_nk = w.t().contiguous()
    eff = torch.from_numpy((rng.uniform(1e-4, 2e-4, n) * eff_mul).astype(np.float32)).to(DEV)
    bias = torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(DEV)
    ones = torch.ones(n, device=DEV)
    # int32 accumulators: unit scale, no bias, fp32 out (exact below 2^24)
    acc_k = km.int8_matmul(x, w, ones, w_nk=w_nk)
    acc_p = km.int8_matmul_plain(x, w, ones)
    bad_acc, _ = _cmp(acc_k, acc_p)
    y = km.int8_matmul_plain(x, w, eff, bias, act=act, act_attrs=act_attrs)
    out_scale = float(y.abs().max()) / 127 * 0.75 if int8_out else None
    kw = dict(act=act, act_attrs=act_attrs, out_scale=out_scale)
    got = km.int8_matmul(x, w, eff, bias, w_nk=w_nk, **kw)
    ref = km.int8_matmul_plain(x, w, eff, bias, **kw)
    bad, err = _cmp(got, ref)
    row = {"kernel": "int8_gemm", "shape": [m, k, n], "act": act,
           "out": "int8" if int8_out else "fp32",
           "plan": km.plan(m, k, n, int8_out)._asdict(),
           "acc_mismatch": bad_acc, "out_mismatch": bad, "max_abs_err": err}
    if eff_mul != 1.0 or act_attrs:
        row["act"] = f"{act} {act_attrs or ''} eff x{eff_mul:g}"
    if timed:
        row["ms"] = time_ms(lambda: km.int8_matmul(x, w, eff, bias, w_nk=w_nk, **kw))
        row["eager_ms"] = eager_ms(lambda: km.int8_matmul(x, w, eff, bias, w_nk=w_nk, **kw))
        row["plain_ms"] = time_ms(lambda: km.int8_matmul_plain(x, w, eff, bias, **kw))
        row["library_ms"] = (time_ms(lambda: torch._int_mm(x, w))
                             if m > 16 and k % 8 == 0 and n % 8 == 0 else None)
        # the same call on the repacked (N, K) weight, transposed: cuBLAS's
        # preferred operand order (information; the yardstick is the above)
        row["library_nk_ms"] = (time_ms(lambda: torch._int_mm(x, w_nk.t()))
                                if row["library_ms"] is not None else None)
        nbytes = m * k + k * n + m * n * (1 if int8_out else 4) + 8 * n
        row.update(bound(nbytes, 2 * m * k * n / INT8_TC_OPS_PER_S))
    return row


def check_dw(rng, shape, int8_out: bool, timed: bool, fma_per_s: float,
             entry: str = "dw_conv_int8", act: str = "relu", act_attrs: dict = None,
             eff_mul: float = 1.0):
    import torch.nn.functional as F

    from paddle_lite_tpu_torch.ops.kernels import depthwise as kd

    n, h, wd, c, k, s = shape
    x = _cuda_rand_int8(rng, (n, h, wd, c))
    w = _cuda_rand_int8(rng, (k, k, 1, c))
    eff = torch.from_numpy((rng.uniform(1e-3, 2e-3, c) * eff_mul).astype(np.float32)).to(DEV)
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
    y = kd.dw_conv_int8_plain(x, w, eff, bias, stride=s, act=act, act_attrs=act_attrs)
    out_scale = float(y.abs().max()) / 127 * 0.75 if int8_out else None
    kw = dict(act=act, act_attrs=act_attrs, out_scale=out_scale)
    got = kern(x, w, eff, bias, **kw)
    ref = kd.dw_conv_int8_plain(x, w, eff, bias, stride=s, **kw)
    bad, err = _cmp(got, ref)
    row = {"kernel": "dw_conv", "entry": entry, "shape": list(shape), "act": act,
           "out": "int8" if int8_out else "fp32",
           "plan": kd.plan(*shape, kd.layout(k))._asdict() if x.is_cuda else None,
           "acc_mismatch": bad_acc, "out_mismatch": bad, "max_abs_err": err}
    if eff_mul != 1.0 or act_attrs:
        row["act"] = f"{act} {act_attrs or ''} eff x{eff_mul:g}"
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


def gemm_edge_rows(rng):
    """The GEMM kernel at its edges, bit-exact against the plain version:
    K = 16, 18, 24, 30 (2-, 8- and 16-byte copies, one slab) and 2048; N =
    18, 30, 1000, 1280; M = 1, 63, 65; every activation of ACTS at K < 256
    and K >= 256 (the epilogue's two conversion paths), int8 and fp32 out;
    hard_swish and relu at extreme magnitudes (requant's clipping).  Then a
    wrapper call on a view misaligned for the plan's copies must raise."""
    from paddle_lite_tpu_torch.ops.kernels import int8_matmul as km

    rows = []
    for m, k, n, int8_out in ((64, 16, 64, True), (64, 18, 72, True), (200, 24, 72, True),
                              (100, 30, 120, False), (64, 2048, 256, True),
                              (500, 64, 18, True), (500, 64, 30, False), (65, 256, 1000, True),
                              (63, 512, 1280, True), (1, 128, 64, True), (63, 40, 100, True),
                              (65, 72, 130, False)):
        rows.append(check_gemm(rng, m, k, n, int8_out, timed=False))
    rows.append(check_gemm(rng, 129, 96, 72, False, False, "hard_sigmoid",
                           {"slope": 0.2, "offset": 0.5}))
    for act in sorted(a for a in km.ACTS if a) + [None]:
        for k in (80, 320):
            for int8_out in (True, False):
                rows.append(check_gemm(rng, 300, k, 96, int8_out, False, act))
    for act, mul in (("hard_swish", 1e19), ("relu", 1e-32), ("hard_swish", 1e-32)):
        for int8_out in (True, False):
            rows.append(check_gemm(rng, 256, 64, 64, int8_out, False, act, eff_mul=mul))
    buf = _cuda_rand_int8(rng, (64 * 64 + 1,))
    try:
        km.int8_matmul(buf[1:].view(64, 64), _cuda_rand_int8(rng, (64, 32)),
                       torch.ones(32, device=DEV))
    except ValueError as e:
        print(f"  int8_gemm on a misaligned view raises: {e}")
    else:
        fail("int8_matmul took a view misaligned for the plan's copies")
    return rows


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
    rows += gemm_edge_rows(rng)
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
    # the tiled kernel's edges: H and W off the tiles, 8-byte copies (C =
    # 72, 24), N = 1, C = 8, fp32 out with hard_swish and hard_sigmoid, and
    # hard_swish at extreme magnitudes (a divisor of 1e30, dividends past
    # 2^60 and below 2^-60)
    for shape, int8_out, act, attrs, eff_mul in (
            ((4, 29, 31, 72, 3, 2), True, "relu", None, 1.0),
            ((2, 15, 9, 24, 5, 1), True, "relu6", None, 1.0),
            ((1, 33, 40, 48, 5, 2), True, "leaky_relu", None, 1.0),
            ((1, 9, 9, 8, 3, 1), True, "relu", None, 1.0),
            ((4, 19, 23, 64, 3, 2), False, "hard_swish", None, 1.0),
            ((2, 15, 9, 40, 5, 1), False, "hard_sigmoid", None, 1.0),
            ((3, 14, 14, 184, 3, 1), True, "hard_swish", None, 1.0),
            ((2, 14, 14, 64, 3, 1), False, "hard_swish", {"scale": 1e30}, 1.0),
            ((2, 9, 11, 40, 5, 2), False, "hard_swish", None, 1e19),
            ((2, 9, 11, 40, 5, 2), False, "hard_swish", None, 1e-32),
            ((2, 9, 11, 40, 5, 2), True, "hard_swish", None, 1e19),
            ((2, 9, 11, 40, 5, 2), True, "hard_swish", None, 1e-32)):
        rows.append(check_dw(rng, shape, int8_out, False, fma_per_s, act=act,
                             act_attrs=attrs, eff_mul=eff_mul))
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
        if r.get("unfused_ms") is not None:
            t += (f" unfused pair {r['unfused_ms']:.4f} | ten a graph: {r['ms_10']:.4f}, "
                  f"pair {r['unfused_ms_10']:.4f}")
        if r["kernel"] in ("dw_conv", "dw_pw_fused") and "ms" in r and r["plan"]:
            t += " | plan " + " ".join(f"{k}={v}" for k, v in r["plan"].items())
        act = r.get("act") or "-"
        print(f"  {r['kernel']:9s} {str(r['shape']):28s} {r['out']:4s} {act:12s} "
              f"acc_mismatch {r['acc_mismatch']} out_mismatch {r['out_mismatch']}{t}")
    for s in (1, 2):  # the depthwise kernel's time per request, by stride
        mine = [r for r in rows if r["kernel"] == "dw_conv"
                and r.get("per_request") and r["shape"][5] == s]
        if not mine:
            continue
        sums = _dw_sums(mine)
        print(f"  dw_conv stride {s}: {sum(r['per_request'] for r in mine)} "
              f"launches a request, " + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()))
    bad = [r for r in rows
           if r["acc_mismatch"] or r["out_mismatch"] or r.get("pair_mismatch")]
    if bad:
        fail(f"{len(bad)} kernel checks disagree with the plain version: {bad}")


def _dw_sums(rows) -> dict:
    """One request's depthwise times (rows counted per request), their
    ratios to the cuDNN call and to the bound."""
    out = {k: sum(r[k] * r["per_request"] for r in rows)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["ms_over_library"] = out["ms"] / out["library_ms"]
    out["ms_over_bound"] = out["ms"] / out["bound_ms"]
    out["shapes_slower_than_library"] = sum(r["ms"] > r["library_ms"] for r in rows)
    return out


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


# the port's kernels by a substring of their symbols, for the profiler's sums
KERNEL_SYMBOLS = {"int8_gemm": "int8_gemm_kernel", "dw_conv": "dw_conv_kernel",
                  "nms": "nms_keep_kernel", "dw_pw_fused": "dw_pw_fused_kernel"}


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
    rows, host = [], []
    for e in prof.key_averages():
        # device-side events only: a CPU op also reports its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    by_kernel = {name: sum(r[0] for r in rows if symbol in r[2])
                 for name, symbol in KERNEL_SYMBOLS.items()}
    return {"wall_ms": wall_ms, "device_ms": sum(r[0] for r in rows),
            "by_kernel_ms": by_kernel,
            "top": [{"ms": r[0], "count": r[1], "name": r[2][:80]}
                    for r in rows[:top]],
            "host_self_ms": sum(r[0] for r in host),
            "host_top": [{"ms": r[0], "count": r[1], "name": r[2][:80]}
                         for r in host[:top]]}


def _reset_counts():
    from paddle_lite_tpu_torch.ops.kernels import depthwise, dw_pw_fused, int8_matmul, nms

    int8_matmul.launches = depthwise.launches = dw_pw_fused.launches = nms.launches = 0
    depthwise.launches_by_stride = {1: 0, 2: 0}


def _counts() -> dict:
    from paddle_lite_tpu_torch.ops.kernels import depthwise, dw_pw_fused, int8_matmul, nms

    return {"int8_gemm": int8_matmul.launches, "dw_conv": depthwise.launches,
            "dw_conv_s1": depthwise.launches_by_stride[1],
            "dw_conv_s2": depthwise.launches_by_stride[2],
            "dw_pw_fused": dw_pw_fused.launches, "nms": nms.launches}


def _serving_numbers(pred8, pred32, feed, batch: int, top: int = 8) -> dict:
    """img/s (host clock, 10 requests; numpy input and input on the card)
    and one profiled request of each predictor (information)."""
    on_dev = {k: torch.from_numpy(v).to(DEV) for k, v in feed.items()}
    out = {}
    for tag, pred in (("int8", pred8), ("fp32", pred32)):
        if pred is None:
            continue
        out[f"{tag}_img_s"] = _ips(pred, feed, batch=batch)
        out[f"{tag}_img_s_input_on_card"] = _ips(pred, on_dev, batch=batch)
    print("  img/s at b%d (host clock, 10 requests; numpy input / input already "
          "on the card): %s" % (batch, ", ".join(
              f"{t} {out[f'{t}_img_s']:.1f} / {out[f'{t}_img_s_input_on_card']:.1f}"
              for t in ("int8", "fp32") if f"{t}_img_s" in out)))
    out["profile"] = {}
    for tag, pred in (("int8", pred8), ("fp32", pred32)):
        if pred is None:
            continue
        out["profile"][tag] = p = _device_breakdown(pred, on_dev, top=top)
        print(f"  {tag} request under the profiler (input on the card): wall "
              f"{p['wall_ms']:.3f} ms, device kernels {p['device_ms']:.3f} ms, "
              f"host ops' self time {p['host_self_ms']:.3f} ms; by kernel, every "
              f"instantiation: {p['by_kernel_ms']}")
        for r in p["top"]:
            print(f"    {r['ms']:.4f} ms x{r['count']} {r['name']}")
        for r in p["host_top"][:5]:
            print(f"    host {r['ms']:.4f} ms x{r['count']} {r['name']}")
    return out


def phase_main_path():
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.core.executor import build_callable
    from paddle_lite_tpu_torch.models import mobilenet_v1
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

    _reset_counts()
    outs = [pred8.run(f) for f in feeds]
    torch.cuda.synchronize()
    launches = _counts()
    print(f"  launches over {REQUESTS} requests: {launches}")
    if ((launches["int8_gemm"], launches["dw_conv"]) != (14 * REQUESTS, 13 * REQUESTS)
            or launches["dw_pw_fused"] or launches["nms"]):
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

    serving = _serving_numbers(pred8, pred32, feeds[0], BATCH)
    unfused = {"calib": calib, "feeds": feeds, "out_name": out_name,
               "outs": [o[out_name] for o in outs], "pred": pred8}
    return launches, dict(serving, op_local_worst_fraction=worst_frac,
                          op_local_worst_lsb=worst_lsb,
                          op_local_outputs_with_diff=n_ops_diff,
                          e2e_worst_int8_fraction=e2e_frac,
                          softmax_max_abs_diff=sm_err, top1_agreement=top1), unfused


# ---- phase 4 ---------------------------------------------------------------

# csrc/nms.cu: 2 min, 4 max, 3 sub, 2 mul, 1 add, 1 compare; none is an FMA,
# so each takes one fp32 instruction slot of a lane
NMS_OPS_PER_PAIR = 13


def nms_needed_pairs(scores, out, score_t) -> float:
    """Pairs that greedy NMS must test on (G, k) `scores` whose result is
    `out`: each kept candidate against every valid candidate it beats
    (score, then slot).  A removed candidate suppresses nothing, so its
    pairs need no test.  Kept means valid with a nonzero result, which
    holds for score_t >= 0."""
    valid = scores > float(np.float32(score_t))
    kept = valid & (out != 0)
    nv = valid.sum(dim=1, keepdim=True)
    # rank among the valid candidates: by score descending, ties by slot
    order = torch.sort(scores.masked_fill(~valid, float("-inf")), dim=1,
                       descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device)
                  .expand_as(order).contiguous())
    return float(((nv - 1 - rank) * kept).sum())


def kernel_shapes(g):
    """(M, K, N, int8 out, act, act attrs) of every GEMM op and
    ((N, H, W, C, k, s), int8 out, act, act attrs) of every depthwise op
    that the optimized graph `g` tags "cuda"."""
    gemm, dw = [], []
    for op in g.topological_order():
        if op.attrs.get("kernel") != "cuda":
            continue
        a = op.attrs
        tail = (a.get("out_scale") is not None, a.get("fuse_act"), a.get("act_attrs") or {})
        if op.op_type in ("conv2d", "depthwise_conv2d"):
            n, h, w, c = g.vars[op.input("Input")].shape
            kh, _, _, oc = g.vars[op.input("Filter")].shape
            if op.op_type == "conv2d":
                gemm.append((n * h * w, c, oc) + tail)
            else:
                dw.append(((n, h, w, c, kh, int(a["strides"][0])),) + tail)
        elif op.op_type == "fc":
            x = g.vars[op.input("Input")].shape
            ncd = int(a.get("in_num_col_dims", len(x) - 1))
            k, n = g.vars[op.input("W")].shape
            gemm.append((int(np.prod(x[:ncd])), k, n) + tail)
    return gemm, dw


def path_kernel_rows(rng, g, path: str, fma_per_s: float):
    """The GEMM and depthwise kernels at every shape, output type and
    activation the graph `g` gives them, each checked and timed once and
    counted per request."""
    gemm, dw = kernel_shapes(g)
    t = torch.zeros(16, device=DEV)
    # the floor moves within a run: read it beside each path's rows
    print(f"  timing floor before the {path} rows: a 16-element add reads "
          f"{time_ms(lambda: t.add_(1)):.4f} ms")
    rows, seen = [], {}
    for m, k, n, int8_out, act, attrs in gemm:
        key = ("gemm", m, k, n, int8_out, act, tuple(sorted(attrs.items())))
        if key not in seen:
            seen[key] = check_gemm(rng, m, k, n, int8_out, True, act, attrs)
            seen[key].update(per_request=0, path=path)
            rows.append(seen[key])
        seen[key]["per_request"] += 1
    for shp, int8_out, act, attrs in dw:
        key = ("dw",) + shp + (int8_out, act, tuple(sorted(attrs.items())))
        if key not in seen:
            seen[key] = check_dw(rng, shp, int8_out, True, fma_per_s, act=act,
                                 act_attrs=attrs)
            seen[key].update(per_request=0, path=path)
            rows.append(seen[key])
        seen[key]["per_request"] += 1
    return rows, gemm, dw


def check_nms(case, boxes, scores, iou_t, score_t, fp32_per_s, timed):
    """The NMS kernel against its plain version, bit for bit; timed, also
    ten calls a graph, the pairs, the bound (13 operations for each pair
    greedy NMS must test, :func:`nms_needed_pairs`, at `fp32_per_s`, the
    fp32 instruction rate, and 24 bytes a candidate) and the plan."""
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
        row["ms_10"] = time_ms(lambda: kn.nms_keep_scores(boxes, scores, **kw), calls=10)
        row["eager_ms"] = eager_ms(lambda: kn.nms_keep_scores(boxes, scores, **kw))
        # the plain version syncs on every Jacobi round: no CUDA graph
        row["plain_ms"] = eager_ms(lambda: kn.nms_keep_scores_plain(boxes, scores, **kw),
                                   reps=5, warmup=1)
        row["library_ms"] = None  # no one PyTorch call computes greedy NMS
        nv = (scores > float(np.float32(score_t))).sum(dim=1).double()
        row["pair_tests"] = float((nv * (nv - 1) / 2).sum())  # pairs of valid candidates
        row["needed_pair_tests"] = nms_needed_pairs(scores, got, score_t)
        # the kernel's schedule, modeled from its loops; not measured
        row["modeled_pair_tests"] = kn.modeled_pair_tests(scores, got, score_t)
        row.update(bound(24.0 * g * k,
                         NMS_OPS_PER_PAIR * row["needed_pair_tests"] / fp32_per_s))
        row["bound_rate"] = f"fp32 instruction rate {fp32_per_s:.4g}/s"
        if boxes.device.type == "cuda":
            lay = kn.layout()
            p = kn.plan(k, lay)
            row["plan"] = dict(p._asdict(), waves=kn.waves(g, p, lay))
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
    from paddle_lite_tpu_torch.ops.kernels import nms, ops_cuda
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
    rows, _, dw = path_kernel_rows(rng, g8, "ssd", fma_per_s)
    env = capture_all(g8, pred8._weights, feeds[0], DEV)
    boxes, scores = env[box_name], env[score_name]
    top_s, cand = ops_cuda.select_candidates(boxes, scores, attrs)
    n, c, k = top_s.shape
    main = check_nms("ssd_bucket3", cand.reshape(n * c, k, 4).contiguous(),
                     top_s.reshape(n * c, k).contiguous(), iou_t, score_t,
                     fma_per_s, timed=True)
    main.update(per_request=1, path="ssd")
    rows.append(main)
    top_e, cand_e = exact_candidates(boxes, scores, min(int(attrs["nms_top_k"]),
                                                        scores.shape[1]))
    ke = top_e.shape[-1]
    rows.append(check_nms("ssd_exact_tier", cand_e.reshape(n * c, ke, 4).contiguous(),
                          top_e.reshape(n * c, ke).contiguous(), iou_t, score_t,
                          fma_per_s, timed=False))
    for case, b, sc in nms_edge_cases(rng):
        rows.append(check_nms(case, b, sc, iou_t, score_t, fma_per_s, timed=False))
    print(f"  kernels at this path's shapes (NMS: G = {n * c} instances of k = {k}, "
          f"{main['valid']} valid and {main['kept']} kept candidates, "
          f"{main['pair_tests']:.10g} pairs of valid candidates, "
          f"{main['needed_pair_tests']:.10g} a kept one against a valid one it beats "
          f"(the bound's), {main['modeled_pair_tests']} by the kernel's schedule, "
          f"modeled, not counted)")
    print(f"  nms ssd_bucket3: one call a graph {main['ms']:.4f} ms, ten a graph "
          f"{main['ms_10']:.4f}, eager {main['eager_ms']:.4f}, plain {main['plain_ms']:.4f}; "
          f"bound {main['bound_ms']:.4f} ms ({main['bound_by']}: {NMS_OPS_PER_PAIR} "
          f"operations for each of the {main['needed_pair_tests']:.10g} pairs greedy NMS "
          f"must test, at the {main['bound_rate']}); plan {main.get('plan')}")
    _report_rows(rows)
    for r in rows:
        if r["kernel"] == "nms":
            print(f"    nms {r['case']}: {r['shape']} kept {r['kept']} of "
                  f"{r['valid']} valid, out_mismatch {r['out_mismatch']}")

    # (b) the path: 3 requests through the predictor
    _reset_counts()
    outs = [pred8.run(f) for f in feeds]
    torch.cuda.synchronize()
    launches = _counts()
    print(f"  launches over {REQUESTS} requests: {launches}")
    n_s1 = sum(1 for d in dw if d[0][5] == 1)
    want = {"int8_gemm": 17, "dw_conv": 13, "dw_conv_s1": n_s1,
            "dw_conv_s2": 13 - n_s1, "dw_pw_fused": 0, "nms": 1}
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
    serving = _serving_numbers(pred8, pred32, feeds[0], SSD_BATCH, top=12)
    return rows, launches, {
        **serving,
        "op_local_worst_fraction": worst_frac, "op_local_worst_lsb": worst_lsb,
        "op_local_outputs_with_diff": n_ops_diff, "detections": n_det,
        "int8_in_fp32_agreement": agree[0], "fp32_in_int8_agreement": agree[1],
        "torch_conv_acc": acc}


# ---- phase 5 ---------------------------------------------------------------

def check_fused(rng, shape, int8_out: bool, timed: bool, fma_per_s: float,
                dw_act: str = "relu", pw_act: str = "relu"):
    """The fused dw+pw kernel at (N, H, W, C, O) against its plain version
    and against the unfused pair of kernels (depthwise, then GEMM) on the
    same inputs: both must agree exactly."""
    from paddle_lite_tpu_torch.ops.kernels import depthwise as kd
    from paddle_lite_tpu_torch.ops.kernels import dw_pw_fused as kf
    from paddle_lite_tpu_torch.ops.kernels import int8_matmul as km

    n, h, w, c, o = shape
    x = _cuda_rand_int8(rng, (n, h, w, c))
    dw = _cuda_rand_int8(rng, (3, 3, 1, c))
    pw = _cuda_rand_int8(rng, (c, o))
    pw_nk = pw.t().contiguous()
    dw_eff = torch.from_numpy(rng.uniform(1e-3, 2e-3, c).astype(np.float32)).to(DEV)
    dw_b = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)).to(DEV)
    pw_eff = torch.from_numpy(rng.uniform(1e-3, 2e-3, o).astype(np.float32)).to(DEV)
    pw_b = torch.from_numpy(rng.normal(0, 0.5, o).astype(np.float32)).to(DEV)
    d = kd.dw_conv_int8_plain(x, dw, dw_eff, dw_b, act=dw_act)
    dw_s = float(d.abs().max()) / 127 * 0.75
    y = kf.fused_dw_pw_int8_plain(x, dw, dw_eff, dw_b, dw_s, pw, pw_eff, pw_b,
                                  dw_act=dw_act, pw_act=pw_act)
    kw = dict(dw_act=dw_act, pw_act=pw_act,
              pw_out_scale=float(y.abs().max()) / 127 * 0.75 if int8_out else None)
    args = (x, dw, dw_eff, dw_b, dw_s, pw, pw_eff, pw_b)

    def pair():
        q = kd.dw_conv_int8(x, dw, dw_eff, dw_b, act=dw_act, out_scale=dw_s)
        return km.int8_matmul(q.reshape(n * h * w, c), pw, pw_eff, pw_b, act=pw_act,
                              out_scale=kw["pw_out_scale"], w_nk=pw_nk)

    got = kf.fused_dw_pw_int8(*args, pw_w_nk=pw_nk, **kw)
    bad, err = _cmp(got, kf.fused_dw_pw_int8_plain(*args, **kw))
    bad_pair, _ = _cmp(got, pair().reshape(got.shape))
    row = {"kernel": "dw_pw_fused", "shape": list(shape), "act": f"{dw_act}/{pw_act}",
           "out": "int8" if int8_out else "fp32",
           "plan": kf.plan(n, h, w, c, o, int8_out, kf.layout())._asdict() if x.is_cuda else None,
           "acc_mismatch": 0, "out_mismatch": bad, "pair_mismatch": bad_pair,
           "max_abs_err": err}
    if timed:
        def fused():
            return kf.fused_dw_pw_int8(*args, pw_w_nk=pw_nk, **kw)

        # in turns: fused, pair, pair, fused (one call a graph, then ten)
        row["ms"] = time_ms(fused)
        row["unfused_ms"] = time_ms(pair)
        row["unfused_ms_10"] = time_ms(pair, calls=10)
        row["ms_10"] = time_ms(fused, calls=10)
        row["eager_ms"] = eager_ms(fused)
        row["plain_ms"] = time_ms(lambda: kf.fused_dw_pw_int8_plain(*args, **kw))
        row["library_ms"] = None  # no one PyTorch call computes this block
        nbytes = (n * h * w * c + 9 * c + c * o + 8 * c + 8 * o
                  + n * h * w * o * (1 if int8_out else 4))
        ops_s = max(9 * n * h * w * c / fma_per_s, 2 * n * h * w * c * o / INT8_TC_OPS_PER_S)
        row.update(bound(nbytes, ops_s))
    return row


def fused_shapes(g):
    """(N, H, W, C, O) of every "cuda" fused_dw_pw op of `g`."""
    out = []
    for op in g.topological_order():
        if op.op_type == "fused_dw_pw" and op.attrs.get("kernel") == "cuda":
            out.append(tuple(g.vars[op.input("Input")].shape)
                       + (g.vars[op.input("PwFilter")].shape[3],))
    return out


def phase_fused(fma_per_s: float, unfused: dict):
    """MobileNetV1 b64/224 with QuantConfig(fuse_dw_pw=True): the fused
    kernel at the path's shapes and ragged ones, then 3 requests."""
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.models import mobilenet_v1
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor
    from paddle_lite_tpu_torch.testing import (TIE_FRACTION, TIE_LSB,
                                               fused_local_diffs, op_local_diffs,
                                               within_tie_bound)

    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    g = mobilenet_v1.build(batch=BATCH, image_size=SIZE, seed=0)
    pred = create_predictor(g, quant=QuantConfig(fuse_dw_pw=True),
                            calib_batches=unfused["calib"], device=DEV)
    print(f"phase 5: MobileNetV1 b{BATCH}/{SIZE} with fuse_dw_pw: build + optimize + "
          f"calibrate {time.perf_counter() - t0:.1f} s")
    shapes = fused_shapes(g)
    print(f"  ops {len(g.ops)}, fused_dw_pw (cuda) at {shapes}")
    if len(shapes) != 2:
        fail(f"expected 2 fused_dw_pw ops, got {shapes}")

    # (a) the kernel against its plain version and the unfused pair
    rows = []
    for shp in shapes:
        rows.append(check_fused(rng, shp, True, True, fma_per_s))
        rows[-1].update(per_request=1, path="mobilenet_v1_fused")
    for shp, int8_out, acts in (((4, 9, 150, 16, 32), True, ("relu", "relu")),  # W > 128
                                ((4, 7, 13, 30, 20), False, ("relu", "relu6")),  # C % 4 != 0
                                ((2, 8, 8, 32, 160), True, ("relu", "relu")),    # O > 128
                                ((4, 14, 14, 64, 96), False, ("hard_swish", "relu")),
                                ((4, 14, 14, 64, 96), True, ("relu", "hard_swish")),
                                ((2, 11, 11, 128, 128), True, ("leaky_relu", "hard_sigmoid")),
                                # C = 8, 24, 40, 72 (8-byte copies) and odd O
                                ((2, 13, 17, 8, 33), True, ("relu", "relu")),
                                ((2, 13, 17, 24, 31), False, ("relu", "relu6")),
                                ((2, 13, 17, 40, 33), True, ("hard_swish", "hard_sigmoid")),
                                ((2, 19, 130, 72, 24), True, (None, "leaky_relu")),
                                ((8, 57, 56, 128, 128), True, ("relu", "relu")),  # H off the band
                                ((4, 45, 45, 64, 96), False, ("relu6", None)),   # W off the runs
                                ((2, 9, 20, 128, 1000), True, ("relu", "relu")),  # O in chunks
                                ((8, 112, 112, 32, 64), False, ("relu", "relu"))):  # 2 sub-tiles
        rows.append(check_fused(rng, shp, int8_out, False, fma_per_s, *acts))
    print("  the fused kernel vs its plain version and the unfused pair "
          "(ms as in phase 2; unfused pair: the depthwise then the GEMM kernel)")
    _report_rows(rows)

    # (b) 3 requests through the predictor
    _reset_counts()
    outs = [pred.run(f) for f in unfused["feeds"]]
    torch.cuda.synchronize()
    launches = _counts()
    print(f"  launches over {REQUESTS} requests: {launches}")
    want = {"int8_gemm": 12, "dw_conv": 11, "dw_conv_s1": 7, "dw_conv_s2": 4,
            "dw_pw_fused": 2, "nms": 0}
    if launches != {k: v * REQUESTS for k, v in want.items()}:
        fail(f"expected {want} launches a request, got {launches} over {REQUESTS}")
    out_name = unfused["out_name"]
    same = [torch.equal(o[out_name], u) for o, u in zip(outs, unfused["outs"])]
    print(f"  softmax equal to phase 3's unfused int8 predictor: {same}")
    if not all(same):
        fail("the fused predictor's softmax differs from the unfused one's")

    # (c) the fused ops against the unfused kernels, the others against torch
    fused = fused_local_diffs(g, pred._weights, unfused["feeds"][0], DEV)
    print(f"  fused ops vs the unfused pair and the plain version on their own "
          f"inputs: {[(d['against'], d['n_diff']) for d in fused]}")
    if len(fused) != 4 or any(d["n_diff"] for d in fused):
        fail(f"a fused op differs from the unfused kernels: {fused}")
    local = op_local_diffs(g, pred._weights, unfused["feeds"][0], DEV)
    worst = max(d["n_diff"] / d["numel"] for d in local)
    print(f"  other kernel ops vs torch op by op: {len(local)} outputs, worst "
          f"fraction {worst:.3g} (bound {TIE_FRACTION}, {TIE_LSB} LSB)")
    if len(local) != 23 or not within_tie_bound(local):
        fail(f"a kernel disagrees with its torch op beyond the tie bound: {local}")
    serving = _serving_numbers(pred, None, unfused["feeds"][0], BATCH)
    # the two int8 predictors in turns (unfused, fused, fused, unfused),
    # input on the card: the host clock moves between calls, so only this
    # comparison says what the fusion does to a request
    on_dev = {"image": torch.from_numpy(unfused["feeds"][0]["image"]).to(DEV)}
    turns = {"unfused": [], "fused": []}
    for tag in ("unfused", "fused", "fused", "unfused"):
        turns[tag].append(_ips(pred if tag == "fused" else unfused["pred"], on_dev,
                               batch=BATCH))
    print(f"  img/s in turns, input on the card: {turns}")
    return rows, launches, dict(serving, op_local_worst_fraction=worst,
                                img_s_in_turns=turns)


# ---- phase 6 ---------------------------------------------------------------

def phase_mnv3(fma_per_s: float):
    """MobileNetV3-Large b64/224 INT8 (QuantConfig() defaults, fp32 islands)."""
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.models import mobilenet_v3
    from paddle_lite_tpu_torch.ops.kernels import depthwise
    from paddle_lite_tpu_torch.ops.kernels.int8_matmul import ACTS
    from paddle_lite_tpu_torch.ops.kernels.select import gemm_eligible
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor
    from paddle_lite_tpu_torch.testing import (TIE_FRACTION, TIE_LSB, op_local_diffs,
                                               within_tie_bound)

    rng = np.random.default_rng(6)
    shape = (BATCH, SIZE, SIZE, 3)
    calib = [{"image": rng.normal(size=shape).astype(np.float32)}]
    feeds = [{"image": rng.normal(size=shape).astype(np.float32)} for _ in range(REQUESTS)]
    kw = dict(batch=BATCH, image_size=SIZE, seed=0, with_softmax=False)
    t0 = time.perf_counter()
    g8 = mobilenet_v3.build(**kw)
    pred8 = create_predictor(g8, quant=QuantConfig(), calib_batches=calib, device=DEV)
    pred32 = create_predictor(mobilenet_v3.build(**kw), device=DEV)
    print(f"phase 6: MobileNetV3-Large b{BATCH}/{SIZE} INT8: build + optimize + "
          f"calibrate {time.perf_counter() - t0:.1f} s")

    # (a) no int8 op that a kernel takes is left on the torch path
    left = []
    for op in g8.ops:
        if not op.attrs.get("enable_int8") or op.attrs.get("kernel") == "cuda":
            continue
        if op.op_type == "depthwise_conv2d":
            takes = depthwise.supported_general(
                op.attrs, g8.vars[op.input("Input")].shape,
                g8.vars[op.input("Filter")].shape)
        else:
            takes = gemm_eligible(g8, op)
        if takes and op.attrs.get("fuse_act") in ACTS and not op.maybe_input("ResidualData"):
            fail(f"{op.op_type} {op.outputs} is left on the torch path")
        left.append(op.op_type + ("+residual" if op.maybe_input("ResidualData") else ""))
    print(f"  ops {len(g8.ops)}; int8 ops on the torch path: {len(left)} {sorted(set(left))}")

    # (b) the kernels at this path's shapes and activations
    rows, gemm, dw = path_kernel_rows(rng, g8, "mobilenet_v3", fma_per_s)
    n_s1 = sum(1 for d in dw if d[0][5] == 1)
    print(f"  kernels at this path's shapes: {len(gemm)} GEMM ops "
          f"({ {a: sum(1 for q in gemm if str(q[4]) == a) for a in sorted({str(q[4]) for q in gemm})} }"
          f" by activation), {len(dw)} depthwise ({n_s1} at stride 1)")
    _report_rows(rows)

    # (c) 3 requests: launches equal the "cuda" ops of each kind
    _reset_counts()
    outs = [pred8.run(f) for f in feeds]
    torch.cuda.synchronize()
    launches = _counts()
    print(f"  launches over {REQUESTS} requests: {launches}")
    want = {"int8_gemm": len(gemm), "dw_conv": len(dw), "dw_conv_s1": n_s1,
            "dw_conv_s2": len(dw) - n_s1, "dw_pw_fused": 0, "nms": 0}
    if launches != {k: v * REQUESTS for k, v in want.items()}:
        fail(f"expected {want} launches a request, got {launches} over {REQUESTS}")
    out_name = g8.outputs[0]
    coss = []
    for i, (f, o) in enumerate(zip(feeds, outs)):
        y = o[out_name]
        if tuple(y.shape) != (BATCH, 1000) or not bool(torch.isfinite(y).all()):
            fail(f"request {i}: logits {tuple(y.shape)} not finite (b, 1000)")
        coss.append(_cosine(y, pred32.run(f)[out_name]))
        print(f"  request {i}: int8 vs fp32 logits cosine {coss[-1]:.6f}")
        if not coss[-1] > 0.96:
            fail(f"request {i}: int8 vs fp32 cosine {coss[-1]} <= 0.96")

    # (d) every kernel op against its torch op on identical inputs
    local = op_local_diffs(g8, pred8._weights, feeds[0], DEV)
    n_diff = sum(1 for d in local if d["n_diff"])
    worst = max(d["n_diff"] / d["numel"] for d in local)
    print(f"  cuda vs torch op by op: {len(local)} outputs, {n_diff} with any "
          f"difference, worst fraction {worst:.3g}, worst "
          f"{max(d['max_diff'] for d in local)} (bound {TIE_FRACTION}, {TIE_LSB} LSB)")
    if len(local) != len(gemm) + len(dw) or not within_tie_bound(local):
        fail(f"a kernel disagrees with its torch op beyond the tie bound: "
             f"{[d for d in local if d['n_diff']]}")
    serving = _serving_numbers(pred8, pred32, feeds[0], BATCH, top=12)
    return rows, launches, dict(serving, cosine=coss, op_local_worst_fraction=worst,
                                op_local_outputs_with_diff=n_diff,
                                torch_path_int8_ops=len(left))


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
    ("dw_pw_fused", "paddle_lite_tpu_torch/csrc/dw_pw_fused.cu",
     "paddle_lite_tpu/ops/kernels/dw_pw_fused.py:114",
     lambda r: r["kernel"] == "dw_pw_fused"),
]


def _gemm_sums(rows) -> dict:
    """One request's GEMM times (rows counted per request): in all and
    beside the bound; over the shapes torch._int_mm takes, beside it and
    its ratio; the shapes with M >= 3136 that read behind it."""
    def total(key, rs):
        return sum(r[key] * r["per_request"] for r in rs)

    lib = [r for r in rows if r["library_ms"] is not None]
    out = {"ms": total("ms", rows), "bound_ms": total("bound_ms", rows),
           "ms_where_library": total("ms", lib), "library_ms": total("library_ms", lib),
           "library_nk_ms": total("library_nk_ms", lib)}
    out["ms_over_library"] = out["ms_where_library"] / out["library_ms"] if lib else None
    out["m3136_shapes_behind_library"] = [
        r["shape"] for r in lib if r["shape"][0] >= 3136 and r["ms"] > r["library_ms"]]
    return out


def _kernel_line(rows, launches_by_path, profiles):
    """One entry per kernel: launches summed over the paths' runs; times
    and bounds summed over one request of every path that has its own
    shape rows (phase 5's GEMM and depthwise shapes are phase 2's).
    ``library_ms`` is null where some shape has no PyTorch call (the
    GEMM's ``torch._int_mm`` needs K, N % 8 == 0); ``library_ms_where_
    available`` and ``ms_where_available`` compare the shapes that do.
    The fused kernel's ``unfused_ms`` is the unfused pair of kernels'."""
    out = []
    for name, src, replaces, covers in KERNELS:
        mine = [r for r in rows if covers(r)]
        timed = [r for r in mine if r.get("per_request")]

        def total(key, rs=timed):
            return sum(r[key] * r["per_request"] for r in rs)

        with_lib = [r for r in timed if r["library_ms"] is not None]
        by_path = {p: n.get(name, 0) for p, n in launches_by_path.items()}
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                         else "operations"),
            "library_ms": total("library_ms") if len(with_lib) == len(timed) else None,
        }
        if with_lib and len(with_lib) < len(timed):
            entry.update(library_ms_where_available=total("library_ms", with_lib),
                         ms_where_available=total("ms", with_lib))
        if name == "dw_pw_fused":
            entry.update(unfused_ms=total("unfused_ms"), ms_10=total("ms_10"),
                         unfused_ms_10=total("unfused_ms_10"))
            entry.update(ms_over_bound=entry["ms"] / entry["bound_ms"],
                         ms_over_pair=entry["ms"] / entry["unfused_ms"],
                         ms_10_over_bound=entry["ms_10"] / entry["bound_ms"],
                         ms_10_over_pair=entry["ms_10"] / entry["unfused_ms_10"],
                         profiled_ms=profiles["mobilenet_v1_fused"]["by_kernel_ms"]["dw_pw_fused"])
        if name == "int8_gemm":
            by = {p: _gemm_sums([r for r in timed if r["path"] == p])
                  for p in sorted({r["path"] for r in timed})}
            entry["by_path"] = by
            entry["profiled_ms_by_path"] = {
                p: {"ms": prof["by_kernel_ms"]["int8_gemm"],
                    "bound_ms": by[p]["bound_ms"] if p in by else None}
                for p, prof in profiles.items()}
        if name == "nms":
            main = next(r for r in timed if r["case"] == "ssd_bucket3")
            entry.update(ms_10=total("ms_10"), eager_ms=total("eager_ms"),
                         profiled_ms=profiles["ssd"]["by_kernel_ms"]["nms"],
                         pair_tests=main["pair_tests"],
                         needed_pair_tests=main["needed_pair_tests"],
                         bound_rate=main["bound_rate"], plan=main.get("plan"))
            entry.update(ms_over_bound=entry["ms"] / entry["bound_ms"],
                         ms_10_over_bound=entry["ms_10"] / entry["bound_ms"])
        if name.startswith("dw_conv_s"):
            by = {p: _dw_sums([r for r in timed if r["path"] == p])
                  for p in sorted({r["path"] for r in timed})}
            entry["by_path"] = by
            entry["ms_over_library"] = entry["ms"] / entry["library_ms"]
            entry["ms_over_bound"] = entry["ms"] / entry["bound_ms"]
        out.append(entry)
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

    t0 = time.perf_counter()
    card, fma_per_s = phase_device()
    rows = phase_kernels(fma_per_s)
    launches, e2e, unfused = phase_main_path()
    ssd_rows, ssd_launches, ssd = phase_ssd(fma_per_s)
    fused_rows, fused_launches, fused = phase_fused(fma_per_s, unfused)
    v3_rows, v3_launches, v3 = phase_mnv3(fma_per_s)
    all_rows = rows + ssd_rows + fused_rows + v3_rows
    kernels = _kernel_line(all_rows, {"mobilenet_v1": launches, "ssd": ssd_launches,
                                      "mobilenet_v1_fused": fused_launches,
                                      "mobilenet_v3": v3_launches},
                           {"mobilenet_v1": e2e["profile"]["int8"],
                            "ssd": ssd["profile"]["int8"],
                            "mobilenet_v1_fused": fused["profile"]["int8"],
                            "mobilenet_v3": v3["profile"]["int8"]})
    gemm = next(k for k in kernels if k["name"] == "int8_gemm")
    for p, v in gemm["by_path"].items():
        print(f"int8_gemm a {p} request: {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}); "
              f"where torch._int_mm takes the shape {v['ms_where_library']:.4f} vs "
              f"{v['library_ms']:.4f} (x{v['ms_over_library']:.3f}; on the (N, K) "
              f"weight {v['library_nk_ms']:.4f}); M >= 3136 shapes behind it: "
              f"{v['m3136_shapes_behind_library']}")
    print(f"int8_gemm profiled a request, every instantiation: {gemm['profiled_ms_by_path']}")
    fu = next(k for k in kernels if k["name"] == "dw_pw_fused")
    print(f"dw_pw_fused a request: one call a graph {fu['ms']:.4f} ms (pair {fu['unfused_ms']:.4f}, "
          f"x{fu['ms_over_pair']:.3f}; bound {fu['bound_ms']:.4f}, x{fu['ms_over_bound']:.2f}); "
          f"ten a graph {fu['ms_10']:.4f} (pair {fu['unfused_ms_10']:.4f}, "
          f"x{fu['ms_10_over_pair']:.3f}; x{fu['ms_10_over_bound']:.2f} the bound); "
          f"profiled {fu['profiled_ms']:.4f} ms")
    nk = next(k for k in kernels if k["name"] == "nms")
    print(f"nms a request: one call a graph {nk['ms']:.4f} ms, ten a graph {nk['ms_10']:.4f} "
          f"(bound {nk['bound_ms']:.4f}, x{nk['ms_over_bound']:.2f} / "
          f"x{nk['ms_10_over_bound']:.2f}); profiled {nk['profiled_ms']:.4f} ms; plain "
          f"{nk['plain_ms']:.4f}; {nk['plan']['blocks_per_sm']} blocks an SM, "
          f"{nk['plan']['waves']:.3f} waves")
    print(f"all phases: {time.perf_counter() - t0:.1f} s")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": all_rows, "main_path": e2e,
                       "ssd": ssd, "mobilenet_v1_fused": fused,
                       "mobilenet_v3": v3, "kernels": kernels}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
