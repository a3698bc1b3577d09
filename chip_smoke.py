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
   → 3 requests through the compiled predictor (one CUDA graph a request:
   the first request's eager warm-up and its capture each launch every
   kernel once through its wrapper, and a replay calls no wrapper, so the
   counters must read twice 14 GEMM and 13 depthwise launches; the profiled
   replay of one request must run 14 and 13).  The int8 output must reach cosine > 0.99 against the
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
   printed with its plan (shared bytes, blocks an SM, waves).  Each of the
   16 int8 3x3 convs (four extra stages, twelve heads) runs as the GEMM
   over its im2col rows: the whole route (copy and kernel), the copy alone
   and the old torch route (an fp32 cuDNN conv, ``round``, the epilogue)
   are timed on the card at each shape, the route within the tie bound of
   the torch op.  Then 3 compiled requests: twice the graph's "cuda" ops
   of each kind (33 GEMM: 17 pointwise and the 16 3x3 convs; 13 depthwise,
   1 NMS) over warm-up and capture, and as many in one profiled replay;
   every kernel op except ``multiclass_nms`` against its torch op on
   identical inputs (tie bound);
   ``multiclass_nms`` with the kernel against the same op with the plain
   version, exactly.  int8 vs fp32 detections, the int8 convs left on the
   torch route with their K and largest accumulator (none since the 3x3
   convs moved), img/s and a profiled request are information.
5. MobileNetV1 b64/224 with ``QuantConfig(fuse_dw_pw=True)``: the fused
   dw+pw kernel at the path's two shapes (timed with one call a graph and
   with ten, beside its bound, its plain version and the unfused pair of
   kernels read the same two ways; each shape prints its plan) and on
   ragged and edge shapes (W > 128, C % 4 != 0 and C = 8, 24, 40, 72, O >
   128 and odd O, O in chunks, H off the band, several sub-tiles a band,
   fp32 out, every activation), each bit-exact against its plain version
   and the unfused pair.  Then phase
   3's 3 requests: twice 2 fused, 11 depthwise (7 at stride 1) and 12
   GEMM launches (warm-up and capture), as many in one profiled replay; the softmax equal to phase 3's; every fused op
   equal to the unfused kernels on its own inputs, the other kernel ops
   within the tie bound of their torch ops.  img/s (also in turns with
   phase 3's predictor) and a profiled request are information.
6. MobileNetV3-Large b64/224 INT8 (``with_softmax=False``): no int8 op
   that a kernel takes is left on the torch path (on every path, phases
   3-6 and 8: nor an int8 conv with K = kh·kw·C > 1040, where an fp32
   conv stops being exact for every input); the GEMM and depthwise
   kernels at every shape and activation of the path (relu, hard_swish,
   hard_sigmoid, none) bit-exact against their plain versions; 3 compiled
   requests with twice as many launches as the graph has "cuda" ops of
   each kind (38 GEMM, 15 depthwise), as many in one profiled replay; every
   kernel op within the tie bound of its torch op; int8 logits against
   the fp32 predictor's, cosine > 0.96 (the bar of
   ``tests/test_model_zoo_int8.py:38``).  img/s and a profiled request
   are information.
7. The compiled path and serving.  (a) For each of the four paths (and
   ResNet-50 in phase 8), the
   compiled request against the eager loop (``build_callable`` on the same
   graph and weights): an eager request after warm-up under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); one
   request's launches counted at capture (``compile_graph`` of the graph
   with every intermediate as an output: warm-up, counters to 0, capture);
   every int8 intermediate equal bit for bit, the outputs within
   ``testing.SOFTMAX_ATOL``; a second call leaves the first result
   unchanged; img/s in turns (eager, compiled, compiled, eager) with a
   numpy input and with the input on the card; one profiled request each
   way, whose compiled host ops' self time (the closing synchronise's wait
   and the profiler's own work apart: its buffer requests, and the part of
   ``cudaGraphLaunch`` that a launch without the profiler does not take,
   the profiler's cost for each kernel of the graph) must be below its
   device kernel time.  SSD with its NMS under
   ``"torch"`` must be refused before capture.  (b) A ``ContinuousBatcher``
   over compiled MobileNetV1 INT8 predictors at buckets 1-64, each
   calibrated on the same 64 images in batches of its size (scales equal
   within 1e-5 relative): 8 client threads send 512 single-image requests
   while four clones of the b64 predictor run on four threads; each result
   within SOFTMAX_ATOL of the b1 predictor's, each clone's output equal to
   the parent's; requests/s, latency, batches, padded slots and peak
   memory printed.  (c) ``tools.benchmark.bench_model("mobilenet_v1",
   batch=64, with_fp32=True)``.
8. ResNet-50 b32/224 INT8 (``resnet.build`` → ``create_predictor(quant=
   QuantConfig(), ...)``, the second ``bench.py`` config): the GEMM kernel
   at every shape of the path (its 37 "cuda" ops: 16 reduce 1x1, 16 3x3
   through im2col, 4 expansion convs, the fc) bit-exact against its plain
   version and timed as in phase 2; the route timings of phase 4 at every
   k×k or strided conv; a saturating 3x3 conv (C = 512, K = 4608, b32 at
   7x7, x and w in 100..127, so the accumulator passes 2^25; fp32 out,
   scale 1) whose GEMM route must equal the exact accumulator rounded
   once to fp32, bit for bit, and so must the ``"torch"`` route (fp32
   convs of input-channel chunks of K <= 1040, each rounded, summed in
   int32; one fp32 conv of the whole K, the route before, printed as
   information); 3 compiled requests with twice the graph's "cuda" ops, as many in one
   profiled replay; every kernel op within the tie bound of its torch op;
   int8 against the fp32 predictor at cosine > 0.98 (the bar of
   ``tests/test_models.py:41``); then phase 7a's checks on this path.
   img/s (compiled, in turns with the eager loop), fp32 img/s, one
   profiled request's top device kernels, and the residual convs left on
   the torch route timed at each shape (the whole op, and its fp32 conv
   and ``round`` alone) are information.
9. DBNet-640 b4 INT8 with its zoo config (``recommended_quant
   ("ppocr_det")``: float depthwise convs, fp32 islands; PP-OCR detection,
   BASELINE config 4): the GEMM at every shape of the path (15 "cuda" ops:
   10 int8 1x1 convs, 5 int8 3x3 convs through im2col at M = 102,400, K =
   864, N = 24) bit-exact against its plain version and timed as in phase
   2; the route timings of phase 4 at its 3x3 convs; 3 compiled requests
   with twice the graph's "cuda" ops, as many in one profiled replay;
   every kernel op within the tie bound of its torch op; the probability
   map against the port's fp32 predictor, mean abs diff < 0.05 (the bar
   of ``tests/test_model_zoo_int8.py:103``); phase 7a's checks on the
   path.  ``db_postprocess``'s boxes a map, img/s and a profiled request
   are information.
10. CRNN b64, strip width 320, INT8 with its zoo config (bf16 islands;
   PP-OCR recognition): the GEMM at every shape of the path (8 "cuda"
   ops: 3 1x1 convs, 4 GRU input projections, the CTC classifier at 5,120
   x 96 x 6,626) as in phase 9 (its three depthwise convs have channel
   multiplier 2, outside the depthwise kernel's domain, and stay on the
   torch route); 3 compiled requests with the launch counts as above;
   every kernel op within the tie bound of its torch op (its fp32 output
   rounded to bf16 as the executor rounds the kernel's); probabilities
   against the port's fp32 predictor at cosine > 0.99 (the bar of
   ``tests/test_model_zoo_int8.py:120``; equal CTC decodes information);
   ``ctc_greedy_decode`` on one tensor equal eager and as a CUDA graph
   captured with host syncs an error; phase 7a's checks on the path; a
   ``LengthBucketer`` over compiled b64 predictors at widths 160 and 320
   answering 64 strips, each result equal, bit for bit, to the strip run
   alone at its bucket.  img/s with bf16 and with fp32 islands in turns
   are information.  (Phase 4b, after phase 4: SSD b32 with its zoo
   config, bf16 islands, against phase 4's fp32 islands in turns: launches
   as phase 4's are checked; img/s, detection agreement and the NMS op's
   input dtype are information.)
11. The last lines: the card (nvidia-smi), the kernels' JSON line, then
   ``{"ok": true, "device": {...}}``.

With ``--json PATH`` the per-shape numbers are also written to PATH.
"""

from __future__ import annotations

import argparse
import copy
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
# a compiled predictor's first request runs the eager loop once (the
# warm-up) and captures it as a CUDA graph, each launching every kernel once
# through its wrapper; a replay calls no wrapper.  So a phase's counted
# requests read twice one request's launches, whatever REQUESTS is.
PER_FIRST_RUN = 2
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


SYNC_EVENTS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize")
# the profiler's own work on the host (CUPTI asking for trace buffers)
PROFILER_EVENTS = ("Activity Buffer Request",)
PROFILED_REQUESTS = 5


def _device_breakdown(pred, feed, top: int = 8, reqs: int = PROFILED_REQUESTS) -> dict:
    """`reqs` requests under torch.profiler, each ending in a synchronise,
    read as one request (totals / reqs): host wall time, summed device
    kernel time, the port's kernels' time and launches, and the kernels
    that take most of it.  The host ops' self time leaves out the wait of
    the synchronise that ends the request (``sync_wait_ms``) and the
    profiler's own host work (``profiler_ms``).  One request under the
    profiler's warm-up step comes first and is not read: the device
    tracing starts during it and may miss its first kernels."""
    from torch.profiler import ProfilerActivity, profile, schedule

    pred.run(feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reqs, repeat=1)) as prof:
        pred.run(feed)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(reqs):
            pred.run(feed)
            torch.cuda.synchronize()
            prof.step()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reqs
    rows, host, sync_ms, prof_ms = [], [], 0.0, 0.0
    for e in prof.key_averages():
        on_host = e.device_type != torch.autograd.DeviceType.CUDA
        if e.key.startswith("ProfilerStep"):  # the schedule's step marks, host and device
            prof_ms += e.self_cpu_time_total / 1e3 / reqs if on_host else 0.0
            continue
        # device-side events only: a CPU op also reports its kernels' time
        if on_host:
            ms = e.self_cpu_time_total / 1e3 / reqs
            if e.key in SYNC_EVENTS:
                sync_ms += ms
            elif e.key in PROFILER_EVENTS:
                prof_ms += ms
            else:
                host.append((ms, e.count / reqs, e.key))
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3 / reqs, e.count / reqs, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    by_kernel = {name: sum(r[0] for r in rows if symbol in r[2])
                 for name, symbol in KERNEL_SYMBOLS.items()}
    counts = {name: sum(r[1] for r in rows if symbol in r[2])
              for name, symbol in KERNEL_SYMBOLS.items()}
    return {"wall_ms": wall_ms, "device_ms": sum(r[0] for r in rows),
            "by_kernel_ms": by_kernel, "kernel_launches": counts,
            "sync_wait_ms": sync_ms, "profiler_ms": prof_ms, "requests": reqs,
            "graph_launch_ms": sum(h[0] for h in host if h[2] == "cudaGraphLaunch"),
            "top": [{"ms": r[0], "count": r[1], "name": r[2][:80]}
                    for r in rows[:top]],
            "host_self_ms": sum(r[0] for r in host),
            "host_top": [{"ms": r[0], "count": r[1], "name": r[2][:80]}
                         for r in host[:top]]}


def _host_ms(pred, feed, reps: int = 20) -> float:
    """Host time of one request without the profiler: the host clock around
    ``run`` with the card idle before each (median of `reps`): what the
    host spends to issue a request, not waiting for it."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.run(feed)
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def _graph_launch_ms(pred, reps: int = 20) -> float:
    """Host time of one ``cudaGraphLaunch`` of the predictor's captured
    graph without the profiler: the host clock around its replay with the
    card idle before it (median of `reps`); 0 for a predictor that has not
    captured.  Under the profiler the same call also pays the profiler's
    own work for each of the graph's kernels."""
    graph = getattr(getattr(pred, "_fn", None), "_cuda_graph", None)
    if graph is None:
        return 0.0
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


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


def path_launches(g) -> dict:
    """One request's launches of each kernel: the "cuda" ops of `g`."""
    gemm, dw = kernel_shapes(g)
    n_s1 = sum(1 for d in dw if d[0][5] == 1)
    return {"int8_gemm": len(gemm), "dw_conv": len(dw), "dw_conv_s1": n_s1,
            "dw_conv_s2": len(dw) - n_s1, "dw_pw_fused": len(fused_shapes(g)),
            "nms": sum(1 for op in g.ops if op.op_type.startswith("multiclass_nms")
                       and op.attrs.get("kernel") == "cuda")}


def _check_first_run(path: str, launches: dict, want: dict) -> None:
    """The counted requests of a fresh compiled predictor: its warm-up and
    its capture launch each kernel once a request; replays call no wrapper."""
    print(f"  launches over {REQUESTS} requests (the first request's warm-up and "
          f"capture; the replays call no wrapper): {launches}")
    if launches != {k: v * PER_FIRST_RUN for k, v in want.items()}:
        fail(f"{path}: expected {PER_FIRST_RUN} x {want} launches over {REQUESTS} "
             f"compiled requests, got {launches}")


def _check_profiled_launches(path: str, prof: dict, want: dict) -> None:
    """The profiled replay of one compiled request runs each kernel as many
    times as the graph has "cuda" ops of its kind."""
    got = prof["kernel_launches"]
    print(f"  kernels in one profiled request ({prof.get('kernels_from', 'the replayed graph')}): "
          f"{got}")
    if got != {k: want[k] for k in KERNEL_SYMBOLS}:
        fail(f"{path}: the profiled request ran {got}, the graph has {want}")


class _Eager:
    """The eager loop (``build_callable``) over a predictor's graph and
    staged weights, warmed up on `feed`: the other side of the compiled
    path's comparisons, with a predictor's ``run``."""

    def __init__(self, pred, feed):
        from paddle_lite_tpu_torch.core.executor import build_callable

        self.graph = pred.graph
        self._fn = build_callable(pred.graph, device=DEV)
        self._weights = pred._weights
        self.run(feed)

    def run(self, feed):
        return self._fn(self._weights, feed)


# path -> (compiled predictor, its requests' feeds, launches a request),
# filled by phases 3-6 for phase 7
PATHS = {}


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
        if p["device_ms"] == 0:  # the profiler saw nothing inside the replay
            e = _device_breakdown(_Eager(pred, on_dev), on_dev, top=top)
            p.update({k: e[k] for k in ("device_ms", "by_kernel_ms", "kernel_launches", "top")},
                     kernels_from="an eager request")
            print(f"  {tag}: the profiler shows no kernel inside the replayed graph; the "
                  f"kernel sums below are an eager request's, wall and host time the "
                  f"compiled one's")
        print(f"  {tag} request under the profiler (compiled, input on the card; "
              f"{p['requests']} requests read as one): wall {p['wall_ms']:.3f} ms, device "
              f"kernels {p['device_ms']:.3f} ms, host ops' self time {p['host_self_ms']:.3f} "
              f"ms (apart: the closing synchronise's wait {p['sync_wait_ms']:.3f} ms, the "
              f"profiler's own {p['profiler_ms']:.3f} ms); by kernel, every "
              f"instantiation: {p['by_kernel_ms']}, launches {p['kernel_launches']}")
        for r in p["top"]:
            print(f"    {r['ms']:.4f} ms x{r['count']:g} {r['name']}")
        for r in p["host_top"][:5]:
            print(f"    host {r['ms']:.4f} ms x{r['count']:g} {r['name']}")
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
    torch_route_ops(g8, "mobilenet_v1")

    want = path_launches(g8)
    if (want["int8_gemm"], want["dw_conv"], want["dw_pw_fused"], want["nms"]) != (14, 13, 0, 0):
        fail(f"expected 14 GEMM and 13 depthwise ops on the kernels, got {want}")
    _reset_counts()
    outs = [pred8.run(f) for f in feeds]
    torch.cuda.synchronize()
    launches = _counts()
    _check_first_run("mobilenet_v1", launches, want)
    PATHS["mobilenet_v1"] = (pred8, feeds, want)

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
    _check_profiled_launches("mobilenet_v1", serving["profile"]["int8"], want)
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
            kh, kw, _, oc = g.vars[op.input("Filter")].shape
            if op.op_type == "conv2d":  # the GEMM over the conv's im2col rows
                _, oh, ow, _ = g.vars[op.output("Output")].shape
                gemm.append((n * oh * ow, kh * kw * c, oc) + tail)
            else:
                dw.append(((n, h, w, c, kh, int(a["strides"][0])),) + tail)
        elif op.op_type == "fc":
            x = g.vars[op.input("Input")].shape
            ncd = int(a.get("in_num_col_dims", len(x) - 1))
            k, n = g.vars[op.input("W")].shape
            gemm.append((int(np.prod(x[:ncd])), k, n) + tail)
        elif op.op_type == "mul":
            x, w = g.vars[op.input("X")].shape, g.vars[op.input("Y")].shape
            xd, yd = int(a.get("x_num_col_dims", 1)), int(a.get("y_num_col_dims", 1))
            gemm.append((int(np.prod(x[:xd])), int(np.prod(x[xd:])),
                         int(np.prod(w[yd:]))) + tail)
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


# an fp32 conv (the "torch" route) is exact for every int8 input only while
# every partial sum stays below 2^24: K·127² < 2^24 up to K = 1040
FP32_EXACT_K = 1040


def torch_route_ops(g, path: str) -> list:
    """The int8 ops of `g` left on the torch route, each as (op type,
    output, K) with K = kh·kw·C for a conv.  Fails if a kernel would take
    one, or if an int8 conv among them has K > FP32_EXACT_K."""
    from paddle_lite_tpu_torch.ops.kernels.select import choose_kernel

    left = []
    for op in g.topological_order():
        if not op.attrs.get("enable_int8") or op.attrs.get("kernel") == "cuda":
            continue
        out = next(iter(op.outputs.values()))[0]
        if choose_kernel(g, op) == "cuda":
            fail(f"{path}: {op.op_type} {out} is left on the torch path")
        k = (int(np.prod(g.vars[op.input("Filter")].shape[:3]))
             if op.op_type in ("conv2d", "depthwise_conv2d") else None)
        if k is not None and k > FP32_EXACT_K:
            fail(f"{path}: int8 {op.op_type} {out} with K = {k} > {FP32_EXACT_K} is on "
                 f"the torch route, an fp32 conv that is not exact past K = {FP32_EXACT_K}")
        left.append((op.op_type + ("+residual" if op.maybe_input("ResidualData") else ""),
                     out, k))
    print(f"  {path}: int8 ops on the torch route: {len(left)}; their largest K "
          f"{max([k for *_, k in left if k is not None], default=None)} (exact up to "
          f"{FP32_EXACT_K}); kinds {sorted({t for t, *_ in left})}")
    return left


def torch_route_convs(g, env, weights, path: str, timed: bool = False) -> dict:
    """The int8 convs left on the torch route (an fp32 conv, exact while
    every partial sum stays below 2^24), each with its K, on this
    request's inputs (`env`): the largest |accumulator| and the largest
    sum of |x·w| (a bound on any partial sum in any order), in float64.
    With `timed`, one row a distinct shape, counted per request: the whole
    "torch" impl, and its accumulator alone (the fp32 cuDNN conv and
    ``round``); the rest of the op's time is its epilogue's elementwise
    passes (scale, bias, the int8 residual dequantized and added, the
    activation, the requant)."""
    from paddle_lite_tpu_torch.core.device import fp32_exact
    from paddle_lite_tpu_torch.core.executor import ExecutionContext
    from paddle_lite_tpu_torch.core.registry import OPS
    from paddle_lite_tpu_torch.ops.common import normalize_2d, normalize_paddings
    from paddle_lite_tpu_torch.ops.nn import conv_nhwc

    ctx = ExecutionContext(graph=g, device=DEV)
    out = {"max_abs_acc": 0.0, "max_sum_abs": 0.0, "op": None, "k": None, "left": [],
           "rows": []}
    seen = {}
    for op in g.topological_order():
        if not (op.op_type == "conv2d" and op.attrs.get("enable_int8")
                and op.attrs.get("kernel") is None):
            continue
        a, name = op.attrs, op.outputs["Output"][0]
        ins = {slot: [env[n] if n in env else weights[n] for n in names]
               for slot, names in op.inputs.items() if names}
        x, w = ins["Input"][0], ins["Filter"][0]
        geom = (normalize_2d(a.get("strides", (1, 1))),
                normalize_paddings(a.get("paddings", (0, 0))),
                normalize_2d(a.get("dilations", (1, 1))), 1)
        w64 = w.to(torch.float64).permute(3, 2, 0, 1).contiguous()
        acc = float(conv_nhwc(x.to(torch.float64), w64, *geom).abs().max())
        sab = float(conv_nhwc(x.to(torch.float64).abs(), w64.abs(), *geom).max())
        k = int(np.prod(w.shape[:3]))
        out["left"].append((name, k))
        if sab > out["max_sum_abs"]:
            out.update(max_sum_abs=sab, op=name, k=k)
        out["max_abs_acc"] = max(out["max_abs_acc"], acc)
        key = (tuple(x.shape), tuple(w.shape), geom)
        if not timed:
            continue
        if key in seen:
            seen[key]["per_request"] += 1
            continue
        w_oihw = w.float().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        with fp32_exact():
            op_ms = time_ms(lambda: OPS.get("conv2d").impls["torch"](ctx, op, ins))
            acc_ms = time_ms(lambda: torch.round(conv_nhwc(x.float(), w_oihw, *geom)))
        seen[key] = {"op": name, "x": list(x.shape), "w": list(w.shape),
                     "strides": list(geom[0]), "residual": bool(op.maybe_input("ResidualData")),
                     "out_elements": int(np.prod(g.vars[name].shape)), "op_ms": op_ms,
                     "acc_ms": acc_ms, "per_request": 1}
        out["rows"].append(seen[key])
    out["n_ops"] = len(out["left"])
    print(f"  {path}: int8 convs on the torch route ({out['n_ops']}, K "
          f"{sorted({k for _, k in out['left']})}): largest |acc| {out['max_abs_acc']:.6g}, "
          f"largest sum |x·w| {out['max_sum_abs']:.6g} (at {out['op']}, K = {out['k']}); "
          f"below 2^24 = {2**24}: {out['max_sum_abs'] < 2**24}")
    for r in out["rows"]:
        print(f"  torch route {r['op']:14s} x {str(r['x']):20s} w {str(r['w']):22s} s "
              f"{r['strides']} x{r['per_request']}: op {r['op_ms']:.4f} ms, of it the fp32 "
              f"conv and round {r['acc_ms']:.4f}")
    if out["rows"]:
        tot = {k: sum(r[k] * r["per_request"] for r in out["rows"])
               for k in ("op_ms", "acc_ms", "out_elements")}
        out.update(request_op_ms=tot["op_ms"], request_acc_ms=tot["acc_ms"])
        print(f"  {path}: a request's int8 convs on the torch route ({out['n_ops']}, "
              f"{tot['out_elements'] / 1e6:.1f} M output elements): {tot['op_ms']:.4f} ms, "
              f"of it the fp32 conv and round {tot['acc_ms']:.4f}, the epilogue's passes "
              f"{tot['op_ms'] - tot['acc_ms']:.4f}")
    return out


def conv_route_rows(rng, g, weights, path: str) -> list:
    """Every "cuda" conv2d of `g` whose GEMM rows need an im2col copy (a
    k×k or strided conv), one row a distinct shape and epilogue, counted
    per request: on one random int8 input of the op's shape, with the op's
    own weights and quant attrs, the whole GEMM route (the "cuda" impl: the
    copy and the kernel), the copy alone (``im2col_nhwc``) and the old
    torch route (the "torch" impl: an fp32 cuDNN conv, ``round`` and the
    epilogue), timed in turns (route, torch, torch, route; the copy
    between) as in phase 2; the route's output against the torch op's
    within the tie bound."""
    from paddle_lite_tpu_torch.core.device import fp32_exact
    from paddle_lite_tpu_torch.core.executor import ExecutionContext
    from paddle_lite_tpu_torch.core.registry import OPS
    from paddle_lite_tpu_torch.ops.common import normalize_2d, normalize_paddings
    from paddle_lite_tpu_torch.ops.kernels.ops_cuda import im2col_nhwc
    from paddle_lite_tpu_torch.testing import within_tie_bound

    ctx = ExecutionContext(graph=g, device=DEV)
    impls = OPS.get("conv2d").impls
    rows, seen = [], {}
    for op in g.topological_order():
        if op.op_type != "conv2d" or op.attrs.get("kernel") != "cuda":
            continue
        a = op.attrs
        kh, kw, c, oc = g.vars[op.input("Filter")].shape
        strides = normalize_2d(a.get("strides", (1, 1)))
        pads = normalize_paddings(a.get("paddings", (0, 0)))
        if (kh, kw, strides, pads) == (1, 1, (1, 1), ((0, 0), (0, 0))):
            continue  # a reshape: no copy
        x_shape = tuple(g.vars[op.input("Input")].shape)
        key = (x_shape, (kh, kw, c, oc), strides, pads, a.get("out_scale") is not None,
               a.get("fuse_act"))
        if key in seen:
            seen[key]["per_request"] += 1
            continue
        x = _cuda_rand_int8(rng, x_shape)
        ins = {"Input": [x], "Filter": [weights[op.input("Filter")]]}
        if op.maybe_input("Bias"):
            ins["Bias"] = [weights[op.input("Bias")]]
        geom = (kh, kw, a.get("strides", (1, 1)), a.get("paddings", (0, 0)))

        def route():
            return impls["cuda"](ctx, op, ins)["Output"][0]

        def old():
            return impls["torch"](ctx, op, ins)["Output"][0]

        with fp32_exact():
            n_diff, max_diff = _cmp(route(), old())
            t = {"route": [], "torch": []}
            for tag in ("route", "torch", "torch", "route"):
                t[tag].append(time_ms(route if tag == "route" else old))
            copy_ms = time_ms(lambda: im2col_nhwc(x, *geom))
        _, oh, ow, _ = g.vars[op.output("Output")].shape
        m, k = x_shape[0] * oh * ow, kh * kw * c
        row = {"path": path, "op": op.outputs["Output"][0], "x": list(x_shape),
               "w": [kh, kw, c, oc], "strides": list(strides), "paddings": [list(p) for p in pads],
               "gemm": [m, k, oc], "out": "int8" if a.get("out_scale") is not None else "fp32",
               "act": a.get("fuse_act"), "route_ms": sum(t["route"]) / 2,
               "torch_ms": sum(t["torch"]) / 2, "turns": t, "copy_ms": copy_ms,
               "copy_bytes": m * k, "n_diff": n_diff, "max_diff": max_diff,
               "numel": m * oc, "per_request": 1}
        seen[key] = row
        rows.append(row)
    for r in rows:
        print(f"  route {r['op']:14s} x {str(r['x']):20s} w {str(r['w']):20s} s "
              f"{r['strides']} GEMM {r['gemm']} {r['out']:4s} {str(r['act']):5s} x{r['per_request']}: "
              f"im2col + kernel {r['route_ms']:.4f} ms (copy alone {r['copy_ms']:.4f}, "
              f"{r['copy_bytes'] / 1e6:.3f} MB), torch route {r['torch_ms']:.4f} ms; "
              f"vs the torch op {r['n_diff']} differ, max {r['max_diff']:.3g}")
    tot = {k: sum(r[k] * r["per_request"] for r in rows)
           for k in ("route_ms", "copy_ms", "torch_ms", "copy_bytes")}
    print(f"  {path}: a request's k×k and strided GEMM convs ({sum(r['per_request'] for r in rows)}): "
          f"im2col + kernel {tot['route_ms']:.4f} ms, of it the copies {tot['copy_ms']:.4f} ms "
          f"({tot['copy_bytes'] / 1e6:.3f} MB written), against the torch route "
          f"{tot['torch_ms']:.4f} ms")
    bad = [r for r in rows if not within_tie_bound(
        [{"numel": r["numel"], "n_diff": r["n_diff"], "max_diff": r["max_diff"]}])]
    if bad:
        fail(f"{path}: the GEMM route disagrees with the torch route beyond the tie "
             f"bound: {bad}")
    return rows


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

    left = torch_route_ops(g8, "ssd")

    # (a) the kernels at this path's shapes, against their plain versions;
    # the k×k convs' GEMM route against the torch route
    rows, _, _ = path_kernel_rows(rng, g8, "ssd", fma_per_s)
    routes = conv_route_rows(rng, g8, pred8._weights, "ssd")
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
    want = path_launches(g8)
    print(f"  kernel ops a request: {want}")
    _reset_counts()
    outs = [pred8.run(f) for f in feeds]
    torch.cuda.synchronize()
    launches = _counts()
    _check_first_run("ssd", launches, want)
    PATHS["ssd"] = (pred8, feeds, want)
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
    if len(local) != want["int8_gemm"] + want["dw_conv"] or not within_tie_bound(local):
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
    acc = torch_route_convs(g8, env, pred8._weights, "ssd")
    del env, local

    # (e) information: throughput and where a request's time goes
    serving = _serving_numbers(pred8, pred32, feeds[0], SSD_BATCH, top=12)
    _check_profiled_launches("ssd", serving["profile"]["int8"], want)
    return rows, launches, {
        **serving,
        "op_local_worst_fraction": worst_frac, "op_local_worst_lsb": worst_lsb,
        "op_local_outputs_with_diff": n_ops_diff, "detections": n_det,
        "int8_in_fp32_agreement": agree[0], "fp32_in_int8_agreement": agree[1],
        "torch_conv_acc": acc, "torch_route_ops": len(left), "conv_routes": routes}


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
    torch_route_ops(g, "mobilenet_v1_fused")
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
    want = {"int8_gemm": 12, "dw_conv": 11, "dw_conv_s1": 7, "dw_conv_s2": 4,
            "dw_pw_fused": 2, "nms": 0}
    if path_launches(g) != want:
        fail(f"expected {want} kernel ops a request, the graph has {path_launches(g)}")
    _reset_counts()
    outs = [pred.run(f) for f in unfused["feeds"]]
    torch.cuda.synchronize()
    launches = _counts()
    _check_first_run("mobilenet_v1_fused", launches, want)
    PATHS["mobilenet_v1_fused"] = (pred, unfused["feeds"], want)
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
    _check_profiled_launches("mobilenet_v1_fused", serving["profile"]["int8"], want)
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
    left = torch_route_ops(g8, "mobilenet_v3")

    # (b) the kernels at this path's shapes and activations
    rows, gemm, dw = path_kernel_rows(rng, g8, "mobilenet_v3", fma_per_s)
    n_s1 = sum(1 for d in dw if d[0][5] == 1)
    print(f"  kernels at this path's shapes: {len(gemm)} GEMM ops "
          f"({ {a: sum(1 for q in gemm if str(q[4]) == a) for a in sorted({str(q[4]) for q in gemm})} }"
          f" by activation), {len(dw)} depthwise ({n_s1} at stride 1)")
    _report_rows(rows)

    # (c) 3 requests: launches equal the "cuda" ops of each kind
    want = path_launches(g8)
    if (want["int8_gemm"], want["dw_conv"], want["dw_pw_fused"], want["nms"]) != (38, 15, 0, 0):
        fail(f"expected 38 GEMM and 15 depthwise ops on the kernels, got {want}")
    _reset_counts()
    outs = [pred8.run(f) for f in feeds]
    torch.cuda.synchronize()
    launches = _counts()
    _check_first_run("mobilenet_v3", launches, want)
    PATHS["mobilenet_v3"] = (pred8, feeds, want)
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
    _check_profiled_launches("mobilenet_v3", serving["profile"]["int8"], want)
    return rows, launches, dict(serving, cosine=coss, op_local_worst_fraction=worst,
                                op_local_outputs_with_diff=n_diff,
                                torch_path_int8_ops=len(left))


# ---- phase 7 ---------------------------------------------------------------

def _with_all_outputs(g):
    """`g` with every op output among its outputs (a shallow copy sharing
    the ops, vars and weights), so that a compiled function returns every
    intermediate."""
    gx = copy.copy(g)
    gx.outputs = list(g.outputs) + [n for op in g.topological_order()
                                    for ns in op.outputs.values() for n in ns
                                    if n not in g.outputs]
    return gx


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def compiled_vs_eager(path: str, pred, feeds, want: dict) -> dict:
    """One path's compiled request against the eager loop on the same graph
    and weights: no host sync in the eager request after warm-up; one
    request's launches counted at capture; every int8 intermediate equal
    bit for bit, the outputs within SOFTMAX_ATOL; a second call leaves the
    first's result unchanged; img/s in turns; profiled requests."""
    from paddle_lite_tpu_torch.core.executor import compile_graph
    from paddle_lite_tpu_torch.testing import SOFTMAX_ATOL, capture_all

    g = pred.graph
    batch = g.vars[g.inputs[0]].shape[0]
    on_dev = [{k: torch.from_numpy(v).to(DEV) for k, v in f.items()} for f in feeds[:2]]
    eager = _Eager(pred, on_dev[0])
    torch.cuda.synchronize()
    # (a) the eager request after warm-up makes no host sync
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager.run(on_dev[1])
    except RuntimeError as e:
        fail(f"{path}: the eager request after warm-up synchronises with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    # (b) launches at capture; every intermediate against the eager loop
    gx = _with_all_outputs(g)
    fn, w = compile_graph(gx, device=DEV)
    fn.warm_up(w, on_dev[0])
    torch.cuda.synchronize()
    _reset_counts()
    fn.capture()
    torch.cuda.synchronize()
    at_capture = _counts()
    first = fn(w, on_dev[0])
    kept = {n: v.clone() for n, v in first.items()}
    fn(w, on_dev[1])
    torch.cuda.synchronize()
    if _counts() != at_capture:
        fail(f"{path}: a replay called a kernel wrapper ({_counts()} vs {at_capture})")
    unchanged = all(torch.equal(first[n], kept[n]) for n in kept)
    env = capture_all(g, pred._weights, feeds[0], DEV)
    int8 = [n for n, v in first.items() if v.dtype == torch.int8]
    int8_bad = [n for n in int8 if not torch.equal(first[n], env[n])]
    out_err = max(_max_diff(first[n], env[n]) for n in g.outputs)
    other_err = max([_max_diff(first[n], env[n]) for n in first
                     if n not in int8 and n not in g.outputs] or [0.0])
    pred_out = pred.run(feeds[0])
    pred_err = max(_max_diff(pred_out[n], env[n]) for n in g.outputs)
    print(f"  {path}: launches a request, counted at capture {at_capture}; "
          f"{len(int8)} int8 tensors, {len(int8_bad)} differ from the eager loop's; "
          f"outputs max abs diff {out_err:.3g} (the predictor's {pred_err:.3g}; bound "
          f"{SOFTMAX_ATOL}); other fp32 intermediates {other_err:.3g}; first result "
          f"unchanged by a second call: {unchanged}")
    if at_capture != want:
        fail(f"{path}: {at_capture} launches at capture, the graph has {want}")
    if int8_bad or out_err > SOFTMAX_ATOL or pred_err > SOFTMAX_ATOL or not unchanged:
        fail(f"{path}: compiled and eager differ (int8 {int8_bad[:5]}, outputs {out_err}, "
             f"predictor {pred_err}) or a second call changed the first result")
    del fn, w, first, kept, env, pred_out
    torch.cuda.empty_cache()

    # (c) img/s in turns, numpy input and input on the card
    turns = {}
    for label, feed in (("numpy", feeds[0]), ("on_card", on_dev[0])):
        t = {"eager": [], "compiled": []}
        for tag in ("eager", "compiled", "compiled", "eager"):
            t[tag].append(_ips(eager if tag == "eager" else pred, feed, batch=batch))
        turns[label] = t
    print(f"  {path}: img/s in turns (eager, compiled, compiled, eager; host clock, 10 "
          f"requests): " + "; ".join(
              f"{lab}: eager {v['eager'][0]:.1f} / {v['eager'][1]:.1f}, compiled "
              f"{v['compiled'][0]:.1f} / {v['compiled'][1]:.1f}" for lab, v in turns.items()))

    # (d) one profiled request each way, input on the card
    prof = {"compiled": _device_breakdown(pred, on_dev[0]),
            "eager": _device_breakdown(eager, on_dev[0])}
    host_ms = {"compiled": _host_ms(pred, on_dev[0]), "eager": _host_ms(eager, on_dev[0])}
    c = prof["compiled"]
    device_ms = c["device_ms"] or prof["eager"]["device_ms"]
    # the profiler's own work inside cudaGraphLaunch (its cost for each of
    # the graph's kernels), set apart as its buffer requests are
    launch_ms = _graph_launch_ms(pred)
    launch_profiler_ms = max(0.0, c.get("graph_launch_ms", 0.0) - launch_ms)
    host_self_ms = c["host_self_ms"] - launch_profiler_ms
    for tag, p in prof.items():
        print(f"  {path} {tag} request under the profiler ({p['requests']} read as one): "
              f"wall {p['wall_ms']:.3f} ms, device kernels {p['device_ms']:.3f} ms, host "
              f"ops' self time {p['host_self_ms']:.3f} ms (apart: the closing synchronise's "
              f"wait {p['sync_wait_ms']:.3f} ms, the profiler's own {p['profiler_ms']:.3f} "
              f"ms); without the profiler the host issues a request in "
              f"{host_ms[tag]:.3f} ms (median of 20); host top: " + ", ".join(
                  f"{r['name']} {r['ms']:.3f} x{r['count']:g}" for r in p["host_top"][:4]))
    if not c["device_ms"]:
        print(f"  {path}: the profiler saw no kernel inside the replayed graph; the "
              f"device time above the compiled host time is the eager request's")
    print(f"  {path}: cudaGraphLaunch takes {c.get('graph_launch_ms', 0.0):.3f} ms under the "
          f"profiler, {launch_ms:.3f} ms without it (median of 20); the compiled host ops' self "
          f"time with the profiler's {launch_profiler_ms:.3f} ms in it set apart: "
          f"{host_self_ms:.3f} ms, against {device_ms:.3f} ms of device kernels")
    if not host_self_ms < device_ms:
        fail(f"{path}: a compiled request's host ops' self time {host_self_ms:.3f} ms (the "
             f"profiler's own {launch_profiler_ms:.3f} ms in cudaGraphLaunch set apart) is not "
             f"below its device kernel time {device_ms:.3f} ms")
    return {"launches_at_capture": at_capture, "int8_tensors": len(int8),
            "output_max_abs_diff": out_err, "img_s_in_turns": turns,
            "host_issue_ms": host_ms, "graph_launch_ms": launch_ms,
            "graph_launch_profiler_ms": launch_profiler_ms,
            "host_self_ms_profiler_apart": host_self_ms,
            "profile": {k: {kk: v[kk] for kk in ("wall_ms", "device_ms", "host_self_ms",
                                                  "sync_wait_ms", "profiler_ms",
                                                  "graph_launch_ms", "kernel_launches",
                                                  "host_top")}
                        for k, v in prof.items()}}


def phase_compiled() -> dict:
    """Phase 7a: each path compiled against eager, then the host-syncing
    NMS impl refused before capture."""
    from paddle_lite_tpu_torch.core.executor import compile_graph
    from paddle_lite_tpu_torch.testing import retag

    print("phase 7: the compiled request path (one CUDA graph a request) against "
          "the eager loop on the same graph")
    out = {path: compiled_vs_eager(path, *PATHS[path]) for path in PATHS}
    bad = retag(PATHS["ssd"][0].graph, "cuda", "torch")
    try:
        compile_graph(bad, device=DEV)
    except ValueError as e:
        if "multiclass_nms" not in str(e):
            fail(f"the torch-tagged SSD was refused for another reason: {e}")
        print(f"  SSD with its NMS under 'torch' is refused before capture: {e}")
    else:
        fail("compile_graph took SSD with the host-syncing torch NMS")
    return out


def phase_serving() -> dict:
    """Phase 7b: a ContinuousBatcher over compiled MobileNetV1 INT8 bucket
    predictors answers 512 single-image requests from 8 client threads,
    while four clones of the b64 predictor run on four more threads."""
    import threading

    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.models import mobilenet_v1
    from paddle_lite_tpu_torch.runtime.batcher import BatcherConfig, ContinuousBatcher
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor
    from paddle_lite_tpu_torch.testing import SOFTMAX_ATOL

    rng = np.random.default_rng(7)
    buckets = (1, 2, 4, 8, 16, 32, 64)
    images = rng.normal(size=(64, SIZE, SIZE, 3)).astype(np.float32)
    t0 = time.perf_counter()
    preds = {}
    for b in buckets:  # each calibrates on the same 64 images, b at a time
        g = mobilenet_v1.build(batch=b, image_size=SIZE, seed=0)
        preds[b] = create_predictor(
            g, quant=QuantConfig(), device=DEV,
            calib_batches=[{"image": images[i:i + b]} for i in range(0, 64, b)])
    print(f"phase 7b: serving MobileNetV1 INT8 {SIZE} px over buckets {buckets}: "
          f"build + optimize + calibrate {time.perf_counter() - t0:.1f} s")

    def scales(g):
        return {n: v.quant.scale for n, v in g.vars.items()
                if v.quant is not None and not v.is_weight}

    ref = scales(preds[64].graph)
    n_equal, worst = 0, 0.0
    for b in buckets:
        sc = scales(preds[b].graph)
        if sc.keys() != ref.keys():
            fail(f"bucket {b} quantized other vars than bucket 64")
        for n, v in sc.items():
            r = np.asarray(ref[n], np.float64)
            rel = float(np.max(np.abs(np.asarray(v, np.float64) - r) / r))
            n_equal += rel == 0.0
            worst = max(worst, rel)
    print(f"  activation scales: {n_equal} of {len(ref) * len(buckets)} equal bit for bit "
          f"to bucket 64's, largest relative difference {worst:.3g} (bound 1e-5: fp32 "
          f"convs at another batch size may sum in another order)")
    if worst > 1e-5:
        fail(f"the buckets' calibrated scales differ by {worst} relative")

    out_name = preds[64].graph.outputs[0]
    parent = preds[64]
    parent_out = parent.run({"image": images})[out_name].cpu()
    clones = [parent.clone() for _ in range(4)]
    n_req, n_clients = 512, 8
    reqs = rng.normal(size=(n_req, SIZE, SIZE, 3)).astype(np.float32)
    results, latency, errors = [None] * n_req, [0.0] * n_req, []
    clone_outs = [None] * len(clones)

    def client(c):
        # bursts of 8 requests, each waited for: batches of many sizes
        try:
            mine = list(range(c, n_req, n_clients))
            for k in range(0, len(mine), 8):
                sent = [(i, time.perf_counter(), batcher.submit({"image": reqs[i]}))
                        for i in mine[k:k + 8]]
                for i, t, f in sent:
                    results[i] = f.result(timeout=600)[out_name].cpu()
                    latency[i] = time.perf_counter() - t
        except Exception as e:  # reported on the main thread
            errors.append(f"client {c}: {e!r}")

    def clone_work(j):
        try:
            clone_outs[j] = [clones[j].run({"image": images})[out_name].cpu()
                             for _ in range(3)]
        except Exception as e:  # reported on the main thread
            errors.append(f"clone {j}: {e!r}")

    captured_before = sum(p._fn.captured for p in preds.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    batcher = ContinuousBatcher(lambda b: preds[b],
                                BatcherConfig(buckets=buckets, max_wait_ms=2.0))
    threads = ([threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
               + [threading.Thread(target=clone_work, args=(j,)) for j in range(len(clones))])
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
    finally:
        batcher.close()
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    if errors or any(t.is_alive() for t in threads):
        fail(f"serving failed: {errors[:5]}")
    used = [b for b in buckets if preds[b]._fn.captured]
    captures = len(used) - captured_before + len(clones)
    want = {k: v * PER_FIRST_RUN * captures
            for k, v in PATHS["mobilenet_v1"][2].items()}
    print(f"  launches in the serving run ({captures} predictors warmed up and "
          f"captured in it, the clones and the buckets first used; buckets used by "
          f"then: {used}; replays call no wrapper): {launches}")
    if launches != want:
        fail(f"serving: expected {want} launches, got {launches}")
    clones_equal = all(torch.equal(o, parent_out) for outs in clone_outs for o in outs)
    b1 = preds[1]
    errs = [_max_diff(results[i], b1.run({"image": reqs[i:i + 1]})[out_name][0].cpu())
            for i in range(n_req)]
    lat = np.sort(np.asarray(latency)) * 1e3
    st = batcher.stats
    serving = {"requests": n_req, "requests_per_s": n_req / wall, "wall_s": wall,
               "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
               "batches": st["batches"], "padded_slots": st["padded_slots"],
               "max_abs_diff_vs_b1": max(errs), "clones_equal_parent": clones_equal,
               "peak_memory_bytes": peak, "launches": launches}
    print(f"  {n_req} requests from {n_clients} client threads in bursts of 8 (and 4 clones of the b64 "
          f"predictor on 4 threads) in {wall:.3f} s: {serving['requests_per_s']:.1f} "
          f"requests/s, latency p50 {serving['p50_ms']:.1f} ms p99 {serving['p99_ms']:.1f} "
          f"ms, {st['batches']} batches, {st['padded_slots']} padded slots; results vs the "
          f"b1 predictor max abs diff {max(errs):.3g} (bound {SOFTMAX_ATOL}); clones equal "
          f"the parent: {clones_equal}; peak device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    if st["requests"] != n_req or max(errs) > SOFTMAX_ATOL or not clones_equal:
        fail(f"serving: {st['requests']} of {n_req} answered, max diff {max(errs)}, "
             f"clones equal {clones_equal}")
    serving["buckets_used"] = used
    return serving


def phase_benchmark() -> dict:
    """Phase 7c: the benchmark tool on the main path."""
    from paddle_lite_tpu_torch.tools.benchmark import bench_model

    t0 = time.perf_counter()
    r = bench_model("mobilenet_v1", batch=BATCH, image_size=SIZE, with_fp32=True,
                    device=DEV)
    print(f"phase 7c: tools.benchmark.bench_model('mobilenet_v1', batch={BATCH}, "
          f"with_fp32=True) in {time.perf_counter() - t0:.1f} s: {json.dumps(r)}")
    return r


# ---- phase 8 ---------------------------------------------------------------

RESNET_BATCH, RESNET_SIZE = 32, 224  # bench.py's second config (bench.py:80-95)


def _torch_route_conv(x: torch.Tensor, w: torch.Tensor, pads) -> torch.Tensor:
    """The port's ``"torch"`` int8 conv2d (input-channel chunks of K <=
    1040 past it, summed in int32) on one op of scale 1, no bias, fp32 out:
    its output is the accumulator converted to fp32."""
    from paddle_lite_tpu_torch.core.executor import build_callable, stage_weights
    from paddle_lite_tpu_torch.core.ir import Graph
    from paddle_lite_tpu_torch.core.types import Precision, QuantInfo

    n, h, wd, _ = x.shape
    kh, kw, _, oc = w.shape
    g = Graph("torch_route_conv")
    g.add_var("x", tuple(x.shape), precision=Precision.INT8).quant = QuantInfo.per_tensor(1.0)
    g.inputs.append("x")
    g.add_weight("w", w.cpu().numpy()).quant = QuantInfo.per_channel_scales(
        np.ones(oc, np.float32), 3)
    g.add_var("y", (n, h + 2 * pads - kh + 1, wd + 2 * pads - kw + 1, oc))
    g.outputs.append("y")
    g.add_op("conv2d", {"Input": ["x"], "Filter": ["w"]}, {"Output": ["y"]},
             {"strides": [1, 1], "paddings": [pads, pads], "dilations": [1, 1],
              "groups": 1, "enable_int8": True})
    g.rebuild_links()
    return build_callable(g, device=DEV)(stage_weights(g, DEV), {"x": x})["y"]


def saturating_conv(rng) -> dict:
    """A 3x3 conv at C = 512 (K = 4608), b32 at 7×7, x and w both drawn
    from 100..127 (one sign), so that the accumulator passes 2^25; fp32
    out, scale 1, no bias, no activation.  The GEMM route (im2col and the
    kernel) and the port's ``"torch"`` route (fp32 convs of input-channel
    chunks of K <= 1040, each rounded, summed in int32) must each equal,
    bit for bit, the exact accumulator rounded once to fp32: what the
    reference's epilogue makes of its int32 accumulator, and what the
    plain version (a float64 matmul, exact below 2^53) gives, itself held
    to a float64 conv.  Whether one fp32 conv of the whole K (cuDNN, then
    ``round``: the torch route before it was chunked) differs there is
    information."""
    from paddle_lite_tpu_torch.core.device import fp32_exact
    from paddle_lite_tpu_torch.ops.kernels import int8_matmul as km
    from paddle_lite_tpu_torch.ops.kernels.ops_cuda import im2col_nhwc
    from paddle_lite_tpu_torch.ops.nn import conv_nhwc

    x = torch.from_numpy(rng.integers(100, 128, size=(32, 7, 7, 512), dtype=np.int8)).to(DEV)
    w = torch.from_numpy(rng.integers(100, 128, size=(3, 3, 512, 512), dtype=np.int8)).to(DEV)
    w2 = w.reshape(4608, 512)
    ones = torch.ones(512, device=DEV)
    geom = ((1, 1), ((1, 1), (1, 1)), (1, 1), 1)
    cols = im2col_nhwc(x, 3, 3, (1, 1), (1, 1))
    got = km.int8_matmul(cols, w2, ones, w_nk=w2.t().contiguous())
    exact = km.int8_matmul_plain(cols, w2, ones)
    acc64 = conv_nhwc(x.double(), w.double().permute(3, 2, 0, 1).contiguous(),
                      *geom).reshape(-1, 512)
    route = _torch_route_conv(x, w, 1).reshape(-1, 512)
    with fp32_exact():
        w_oihw = w.float().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        fp32 = torch.round(conv_nhwc(x.float(), w_oihw, *geom)).reshape(-1, 512)
    out = {"shape": [32, 7, 7, 512, 3, 512], "k": 4608, "max_acc": float(acc64.max()),
           "kernel_vs_exact": _cmp(got, exact)[0],
           "plain_vs_float64_conv": _cmp(exact, acc64.float())[0],
           "torch_route_vs_exact": _cmp(route, acc64.float())[0],
           "one_fp32_conv_vs_exact": _cmp(fp32, acc64.float())[0],
           "one_fp32_conv_max_err": _cmp(fp32, acc64)[1]}
    print(f"  saturating 3x3 conv, C 512 (K 4608), b32 at 7x7, x and w in 100..127: largest "
          f"accumulator {out['max_acc']:.10g} (2^25 = {2**25}); against the exact accumulator "
          f"rounded once to fp32, the GEMM route differs in {out['kernel_vs_exact']} elements "
          f"(the plain version from a float64 conv in {out['plain_vs_float64_conv']}), the "
          f"torch route (chunks of K <= 1040, int32 sum) in {out['torch_route_vs_exact']}; "
          f"information: one fp32 conv of the whole K differs in "
          f"{out['one_fp32_conv_vs_exact']} of {got.numel()}, by up to "
          f"{out['one_fp32_conv_max_err']:.6g} from the exact sum")
    if not out["max_acc"] > 2 ** 25:
        fail(f"the saturating case's accumulator {out['max_acc']} does not pass 2^25")
    if out["kernel_vs_exact"] or out["plain_vs_float64_conv"] or out["torch_route_vs_exact"]:
        fail(f"a route is not the exact accumulator rounded once to fp32: {out}")
    return out


def phase_resnet(fma_per_s: float):
    """ResNet-50 b32/224 INT8 (QuantConfig() defaults): the GEMM at every
    shape of the path, the k×k and strided convs' routes, the saturating
    case, 3 compiled requests, then phase 7a's check on this path."""
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.models import resnet
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor
    from paddle_lite_tpu_torch.testing import (TIE_FRACTION, TIE_LSB, capture_all,
                                               op_local_diffs, within_tie_bound)

    rng = np.random.default_rng(8)
    shape = (RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3)
    calib = [{"image": rng.normal(size=shape).astype(np.float32)}]
    feeds = [{"image": rng.normal(size=shape).astype(np.float32)} for _ in range(REQUESTS)]
    kw = dict(batch=RESNET_BATCH, image_size=RESNET_SIZE, seed=0)
    t0 = time.perf_counter()
    g8 = resnet.build(**kw)
    pred8 = create_predictor(g8, quant=QuantConfig(), calib_batches=calib, device=DEV)
    pred32 = create_predictor(resnet.build(**kw), device=DEV)
    print(f"phase 8: ResNet-50 b{RESNET_BATCH}/{RESNET_SIZE} INT8: build + optimize + "
          f"calibrate {time.perf_counter() - t0:.1f} s; ops {len(g8.ops)}")
    left = torch_route_ops(g8, "resnet50")

    # (a) the GEMM at this path's shapes; the k×k and strided convs' routes;
    # the saturating case
    rows, gemm, _ = path_kernel_rows(rng, g8, "resnet50", fma_per_s)
    print(f"  kernels at this path's shapes: {len(gemm)} GEMM ops, "
          f"{len({tuple(r['shape']) for r in rows})} distinct (M, K, N)")
    _report_rows(rows)
    routes = conv_route_rows(rng, g8, pred8._weights, "resnet50")
    sat = saturating_conv(rng)

    # (b) 3 requests: launches equal the "cuda" ops
    want = path_launches(g8)
    print(f"  kernel ops a request: {want}")
    if (want["int8_gemm"], want["dw_conv"], want["dw_pw_fused"], want["nms"]) != (37, 0, 0, 0):
        fail(f"expected 37 GEMM ops on the kernels, got {want}")
    _reset_counts()
    outs = [pred8.run(f) for f in feeds]
    torch.cuda.synchronize()
    launches = _counts()
    _check_first_run("resnet50", launches, want)
    out_name = g8.outputs[0]
    coss = []
    for i, (f, o) in enumerate(zip(feeds, outs)):
        y = o[out_name]
        if tuple(y.shape) != (RESNET_BATCH, 1000) or not bool(torch.isfinite(y).all()):
            fail(f"request {i}: output {tuple(y.shape)} not finite (b, 1000)")
        coss.append(_cosine(y, pred32.run(f)[out_name]))
        print(f"  request {i}: int8 vs fp32 cosine {coss[-1]:.6f}")
        if not coss[-1] > 0.98:
            fail(f"request {i}: int8 vs fp32 cosine {coss[-1]} <= 0.98")

    # (c) every kernel op against its torch op on identical inputs; the
    # torch route's accumulators (information)
    local = op_local_diffs(g8, pred8._weights, feeds[0], DEV)
    n_diff = sum(1 for d in local if d["n_diff"])
    worst = max(d["n_diff"] / d["numel"] for d in local)
    print(f"  cuda vs torch op by op: {len(local)} outputs, {n_diff} with any "
          f"difference, worst fraction {worst:.3g}, worst "
          f"{max(d['max_diff'] for d in local)} (bound {TIE_FRACTION}, {TIE_LSB} LSB)")
    if len(local) != want["int8_gemm"] or not within_tie_bound(local):
        fail(f"a kernel disagrees with its torch op beyond the tie bound: "
             f"{[d for d in local if d['n_diff']]}")
    env = capture_all(g8, pred8._weights, feeds[0], DEV)
    acc = torch_route_convs(g8, env, pred8._weights, "resnet50", timed=True)
    del env, local

    # (d) information: throughput and where a request's time goes; then the
    # compiled request against the eager loop, as phase 7a does
    serving = _serving_numbers(pred8, pred32, feeds[0], RESNET_BATCH, top=16)
    _check_profiled_launches("resnet50", serving["profile"]["int8"], want)
    compiled = compiled_vs_eager("resnet50", pred8, feeds, want)
    return rows, launches, dict(serving, cosine=coss, op_local_worst_fraction=worst,
                                op_local_outputs_with_diff=n_diff,
                                torch_route_ops=len(left), torch_conv_acc=acc,
                                conv_routes=routes, saturating=sat), compiled


# ---- phase 9 ---------------------------------------------------------------

DBNET_BATCH, DBNET_SIZE = 4, 640  # the reference benchmark's DBNet (tools/benchmark.py:32-35)
DBNET_MAP_MEAN_ABS = 0.05  # the reference's bar (tests/test_model_zoo_int8.py:103)


def _path_checks(path: str, g8, pred8, feeds, want: dict) -> dict:
    """Three compiled requests (launches: twice the graph's "cuda" ops of
    each kind) and every kernel op within the tie bound of its torch op on
    identical inputs; returns the outputs and the op-by-op numbers."""
    from paddle_lite_tpu_torch.testing import (TIE_FRACTION, TIE_LSB, op_local_diffs,
                                               within_tie_bound)

    _reset_counts()
    outs = [pred8.run(f) for f in feeds]
    torch.cuda.synchronize()
    launches = _counts()
    _check_first_run(path, launches, want)
    local = op_local_diffs(g8, pred8._weights, feeds[0], DEV)
    n_diff = sum(1 for d in local if d["n_diff"])
    worst = max(d["n_diff"] / d["numel"] for d in local)
    print(f"  cuda vs torch op by op: {len(local)} outputs, {n_diff} with any "
          f"difference, worst fraction {worst:.3g}, worst "
          f"{max(d['max_diff'] for d in local)} (bound {TIE_FRACTION}, {TIE_LSB} LSB)")
    if len(local) != want["int8_gemm"] + want["dw_conv"] or not within_tie_bound(local):
        fail(f"{path}: a kernel disagrees with its torch op beyond the tie bound: "
             f"{[d for d in local if d['n_diff']]}")
    return {"outs": outs, "launches": launches, "op_local_worst_fraction": worst,
            "op_local_outputs_with_diff": n_diff}


def phase_dbnet(fma_per_s: float):
    """Phase 9: DBNet-640 b4 INT8 with its zoo config (float depthwise
    convs, fp32 islands)."""
    from paddle_lite_tpu_torch.models import ppocr
    from paddle_lite_tpu_torch.models.zoo_config import recommended_quant
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor
    from paddle_lite_tpu_torch.tools.db_postprocess import extract_boxes

    rng = np.random.default_rng(9)
    shape = (DBNET_BATCH, DBNET_SIZE, DBNET_SIZE, 3)
    calib = [{"image": rng.normal(size=shape).astype(np.float32)}]
    feeds = [{"image": rng.normal(size=shape).astype(np.float32)} for _ in range(REQUESTS)]
    kw = dict(batch=DBNET_BATCH, image_size=DBNET_SIZE, seed=0)
    t0 = time.perf_counter()
    g8 = ppocr.build_det(**kw)
    pred8 = create_predictor(g8, quant=recommended_quant("ppocr_det"), calib_batches=calib,
                             device=DEV)
    pred32 = create_predictor(ppocr.build_det(**kw), device=DEV)
    print(f"phase 9: DBNet b{DBNET_BATCH}/{DBNET_SIZE} INT8 ({recommended_quant('ppocr_det')}): "
          f"build + optimize + calibrate {time.perf_counter() - t0:.1f} s; ops {len(g8.ops)}")
    left = torch_route_ops(g8, "dbnet")

    # (a) the GEMM at this path's shapes; the 3x3 convs' routes
    rows, gemm, dw = path_kernel_rows(rng, g8, "dbnet", fma_per_s)
    print(f"  kernels at this path's shapes: {len(gemm)} GEMM ops, {len(dw)} depthwise")
    _report_rows(rows)
    routes = conv_route_rows(rng, g8, pred8._weights, "dbnet")

    # (b) 3 requests; every kernel op against its torch op
    want = path_launches(g8)
    print(f"  kernel ops a request: {want}")
    if (want["int8_gemm"], want["dw_conv"], want["dw_pw_fused"], want["nms"]) != (15, 0, 0, 0):
        fail(f"expected 15 GEMM ops on the kernels, got {want}")
    checks = _path_checks("dbnet", g8, pred8, feeds, want)
    PATHS["dbnet"] = (pred8, feeds, want)
    out_name = g8.outputs[0]
    diffs, boxes = [], []
    for i, (f, o) in enumerate(zip(feeds, checks["outs"])):
        y = o[out_name]
        if (tuple(y.shape) != (DBNET_BATCH, DBNET_SIZE, DBNET_SIZE, 1)
                or not bool(torch.isfinite(y).all()) or not bool(((y >= 0) & (y <= 1)).all())):
            fail(f"request {i}: map {tuple(y.shape)} is not a finite (b, H, W, 1) in [0, 1]")
        diffs.append(float((y - pred32.run(f)[out_name]).abs().mean()))
        boxes.append([len(extract_boxes(m)) for m in y.cpu().numpy()])
        print(f"  request {i}: int8 vs fp32 probability map mean abs diff {diffs[-1]:.6f} "
              f"(bar {DBNET_MAP_MEAN_ABS}); db_postprocess boxes a map {boxes[-1]}")
        if not diffs[-1] < DBNET_MAP_MEAN_ABS:
            fail(f"request {i}: map mean abs diff {diffs[-1]} >= {DBNET_MAP_MEAN_ABS}")

    # (c) information: throughput, where a request's time goes; then the
    # compiled request against the eager loop, as phase 7a does
    serving = _serving_numbers(pred8, pred32, feeds[0], DBNET_BATCH, top=16)
    _check_profiled_launches("dbnet", serving["profile"]["int8"], want)
    compiled = compiled_vs_eager("dbnet", pred8, feeds, want)
    return rows, checks["launches"], dict(
        serving, map_mean_abs_diff=diffs, boxes=boxes, torch_route_ops=len(left),
        conv_routes=routes, op_local_worst_fraction=checks["op_local_worst_fraction"],
        op_local_outputs_with_diff=checks["op_local_outputs_with_diff"]), compiled


# ---- phase 10 --------------------------------------------------------------

CRNN_BATCH, CRNN_WIDTH = 64, 320  # the reference benchmark's CRNN (tools/benchmark.py:37-40)
CRNN_COSINE = 0.99  # the reference's bar (tests/test_model_zoo_int8.py:120)


def _ctc_compiled_vs_eager(probs: torch.Tensor) -> dict:
    """``ctc_greedy_decode`` on one probability tensor, eager and as a CUDA
    graph captured under ``set_sync_debug_mode("error")`` (a host sync
    inside the op would raise): both outputs equal."""
    from paddle_lite_tpu_torch.core.registry import OPS

    impl = OPS.get("ctc_greedy_decode").impls["torch"]

    class Op:
        attrs = {}

    eager = impl(None, Op, {"X": [probs]})
    static = probs.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        impl(None, Op, {"X": [static]})
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            got = impl(None, Op, {"X": [static]})
        graph.replay()
    except RuntimeError as e:
        fail(f"ctc_greedy_decode synchronises with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    equal = all(torch.equal(got[k][0], eager[k][0]) for k in ("Out", "Length"))
    print(f"  ctc_greedy_decode on {tuple(probs.shape)} {probs.dtype}: CUDA graph (captured "
          f"with host syncs an error) equal to eager: {equal}; mean length "
          f"{float(eager['Length'][0].float().mean()):.2f}")
    if not equal:
        fail("ctc_greedy_decode differs between its CUDA graph and eager")
    return {"equal": equal}


def _bucketer_run(rng) -> dict:
    """A LengthBucketer over compiled CRNN b64 predictors at strip widths
    160 and 320 (bf16 islands): 64 strips of widths 100..320 go to their
    width bucket, zero-padded; each result's probabilities and decode must
    equal, bit for bit, the same strip run alone (zero-padded to its
    bucket, the other rows zero) through that bucket's predictor."""
    from paddle_lite_tpu_torch.models import ppocr
    from paddle_lite_tpu_torch.models.zoo_config import recommended_quant
    from paddle_lite_tpu_torch.runtime.batcher import BatcherConfig
    from paddle_lite_tpu_torch.runtime.length_bucketer import LengthBucketer, default_pad_fn
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor

    preds = {}
    calib_images = rng.normal(size=(CRNN_BATCH, 32, 320, 3)).astype(np.float32)

    def factory(batch, width):
        g = ppocr.build_rec(batch=batch, width=width, seed=0)
        preds[width] = create_predictor(
            g, quant=recommended_quant("ppocr_rec"), device=DEV,
            calib_batches=[{"image": calib_images[:batch, :, :width]}])
        return preds[width]

    widths = np.concatenate([rng.integers(100, 161, 32), rng.integers(161, 321, 32)])
    strips = [rng.normal(size=(32, int(w), 3)).astype(np.float32) for w in widths]
    t0 = time.perf_counter()
    lb = LengthBucketer(factory, length_buckets=(160, 320), seq_axes={"image": 1},
                        batcher_config=BatcherConfig(buckets=(CRNN_BATCH,), max_wait_ms=5.0))
    try:
        futs = [lb.submit({"image": x}) for x in strips]
        results = [f.result(timeout=600) for f in futs]
    finally:
        lb.close()
    secs = time.perf_counter() - t0
    bad = 0
    for x, r in zip(strips, results):
        width = 160 if x.shape[1] <= 160 else 320
        pred = preds[width]
        g = pred.graph
        batch = np.zeros((CRNN_BATCH, 32, width, 3), np.float32)
        batch[0] = default_pad_fn({"image": x}, width, {"image": 1})["image"]
        alone = pred.run({"image": batch})
        for n in g.outputs:
            if not torch.equal(alone[n][0].cpu(), torch.as_tensor(r[n]).cpu()):
                bad += 1
    print(f"  LengthBucketer, buckets 160 / 320 over compiled b{CRNN_BATCH} predictors: "
          f"{len(strips)} strips of widths {int(widths.min())}..{int(widths.max())} in "
          f"{secs:.1f} s (predictors built on first use), {lb.stats['padded_tokens']} padded "
          f"columns; results unequal to the strip run alone at its bucket: {bad}")
    if bad:
        fail(f"LengthBucketer: {bad} results differ from the strip run alone")
    return {"strips": len(strips), "seconds": secs, "padded_columns": lb.stats["padded_tokens"]}


def phase_crnn(fma_per_s: float):
    """Phase 10: CRNN-320 b64 INT8 with its zoo config (bf16 islands)."""
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.models import ppocr
    from paddle_lite_tpu_torch.models.zoo_config import recommended_quant
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor

    rng = np.random.default_rng(10)
    shape = (CRNN_BATCH, 32, CRNN_WIDTH, 3)
    calib_images = rng.normal(size=shape).astype(np.float32)
    calib = [{"image": calib_images}]
    feeds = [{"image": rng.normal(size=shape).astype(np.float32)} for _ in range(REQUESTS)]
    kw = dict(batch=CRNN_BATCH, width=CRNN_WIDTH, seed=0)
    quant = recommended_quant("ppocr_rec")
    t0 = time.perf_counter()
    g8 = ppocr.build_rec(**kw)
    pred8 = create_predictor(g8, quant=quant, calib_batches=calib, device=DEV)
    pred8_f32 = create_predictor(ppocr.build_rec(**kw), quant=QuantConfig(),
                                 calib_batches=calib, device=DEV)
    pred32 = create_predictor(ppocr.build_rec(**kw), device=DEV)
    print(f"phase 10: CRNN b{CRNN_BATCH} strip width {CRNN_WIDTH} INT8 ({quant}): build + "
          f"optimize + calibrate {time.perf_counter() - t0:.1f} s; ops {len(g8.ops)}; "
          f"island {g8.meta.get('island_dtype')}")
    left = torch_route_ops(g8, "crnn")
    dw_left = [(op.outputs["Output"][0], g8.vars[op.input("Input")].shape[-1],
                g8.vars[op.input("Filter")].shape[-1])
               for op in g8.topological_order() if op.op_type == "depthwise_conv2d"]
    print(f"  depthwise convs (output, C in, C out) on the torch route, channel multiplier "
          f"2, outside the depthwise kernel's domain (as the TPU kernel's): {dw_left}")

    # (a) the GEMM at this path's shapes
    rows, gemm, dw = path_kernel_rows(rng, g8, "crnn", fma_per_s)
    print(f"  kernels at this path's shapes: {len(gemm)} GEMM ops, {len(dw)} depthwise")
    _report_rows(rows)

    # (b) 3 requests; every kernel op against its torch op
    want = path_launches(g8)
    print(f"  kernel ops a request: {want}")
    if (want["int8_gemm"], want["dw_conv"], want["dw_pw_fused"], want["nms"]) != (8, 0, 0, 0):
        fail(f"expected 8 GEMM ops on the kernels, got {want}")
    checks = _path_checks("crnn", g8, pred8, feeds, want)
    PATHS["crnn"] = (pred8, feeds, want)
    probs_name, dec_name = g8.outputs
    t = CRNN_WIDTH // 4
    coss, same = [], []
    for i, (f, o) in enumerate(zip(feeds, checks["outs"])):
        p, d = o[probs_name], o[dec_name]
        if (tuple(p.shape) != (CRNN_BATCH, t, 6626) or p.dtype != torch.float32
                or not bool(torch.isfinite(p).all()) or tuple(d.shape) != (CRNN_BATCH, t)
                or d.dtype != torch.int32):
            fail(f"request {i}: outputs {tuple(p.shape)} {p.dtype}, {tuple(d.shape)} {d.dtype}")
        ref = pred32.run(f)
        coss.append(_cosine(p, ref[probs_name]))
        same.append(float((d == ref[dec_name]).all(dim=1).float().mean()))
        print(f"  request {i}: int8 (bf16 islands) vs fp32 probabilities cosine {coss[-1]:.6f}; "
              f"equal CTC decodes {same[-1]:.4f} of strips")
        if not coss[-1] > CRNN_COSINE:
            fail(f"request {i}: probabilities cosine {coss[-1]} <= {CRNN_COSINE}")
    ctc = _ctc_compiled_vs_eager(checks["outs"][0][probs_name].to(DEV).to(torch.bfloat16))

    # (c) information: bf16 against fp32 islands in turns, throughput, a
    # profiled request; then phase 7a's check on this path; the bucketer
    turns = {"bf16": [], "fp32": []}
    for tag in ("bf16", "fp32", "fp32", "bf16"):
        turns[tag].append(_ips(pred8 if tag == "bf16" else pred8_f32, feeds[0],
                               batch=CRNN_BATCH))
    cos_islands = _cosine(pred8.run(feeds[0])[probs_name], pred8_f32.run(feeds[0])[probs_name])
    print(f"  img/s in turns, int8 with bf16 islands / fp32 islands: "
          f"{turns['bf16'][0]:.1f}, {turns['fp32'][0]:.1f}, {turns['fp32'][1]:.1f}, "
          f"{turns['bf16'][1]:.1f}; bf16 vs fp32 islands probabilities cosine {cos_islands:.6f}")
    serving = _serving_numbers(pred8, pred32, feeds[0], CRNN_BATCH, top=16)
    _check_profiled_launches("crnn", serving["profile"]["int8"], want)
    compiled = compiled_vs_eager("crnn", pred8, feeds, want)
    del pred8_f32
    bucketer = _bucketer_run(rng)
    return rows, checks["launches"], dict(
        serving, cosine=coss, equal_decodes=same, ctc=ctc, islands_img_s_in_turns=turns,
        islands_cosine=cos_islands, bucketer=bucketer, torch_route_ops=len(left),
        depthwise_on_torch_route=dw_left,
        op_local_worst_fraction=checks["op_local_worst_fraction"],
        op_local_outputs_with_diff=checks["op_local_outputs_with_diff"]), compiled


def phase_ssd_islands(ssd_pred8):
    """SSD b32 with its zoo config (bf16 islands) against phase 4's int8
    predictor (fp32 islands), in turns: img/s, detection agreement and the
    NMS op's input dtype (information); its launches as phase 4's."""
    from paddle_lite_tpu_torch.core.executor import build_callable
    from paddle_lite_tpu_torch.models import ssd
    from paddle_lite_tpu_torch.models.zoo_config import recommended_quant
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor

    rng = np.random.default_rng(1)
    shape = (SSD_BATCH, SSD_SIZE, SSD_SIZE, 3)
    calib = [{"image": rng.normal(size=shape).astype(np.float32)}]  # phase 4's batch
    feed = {"image": rng.normal(size=shape).astype(np.float32)}
    kw = dict(batch=SSD_BATCH, image_size=SSD_SIZE, num_classes=SSD_CLASSES, seed=0)
    g = ssd.build(**kw)
    pred = create_predictor(g, quant=recommended_quant("ssd"), calib_batches=calib, device=DEV)
    want = path_launches(g)
    _reset_counts()
    outs = [pred.run(feed) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    _check_first_run("ssd_bf16_islands", _counts(), want)
    nms = next(op for op in g.ops if op.op_type == "multiclass_nms")
    seen = {}
    build_callable(g, device=DEV, capture=lambda n, v: seen.__setitem__(n, v.dtype)
                   if n in (nms.input("BBoxes"), nms.input("Scores")) else None)(
        pred._weights, feed)
    out_name = g.outputs[0]
    ref = ssd_pred8.run(feed)[out_name]
    agree = (_det_agreement(outs[0][out_name], ref), _det_agreement(ref, outs[0][out_name]))
    turns = {"bf16": [], "fp32": []}
    for tag in ("bf16", "fp32", "fp32", "bf16"):
        turns[tag].append(_ips(pred if tag == "bf16" else ssd_pred8, feed, batch=SSD_BATCH))
    print(f"phase 4b: SSD b{SSD_BATCH} INT8 with its zoo config (bf16 islands): launches as "
          f"phase 4's {want}; NMS input dtypes {sorted({str(v) for v in seen.values()})}; "
          f"detections against fp32 islands (same label, IoU >= 0.5): {agree[0]:.4f} of "
          f"bf16's found, {agree[1]:.4f} of fp32's; img/s in turns bf16 / fp32 islands: "
          f"{turns['bf16'][0]:.1f}, {turns['fp32'][0]:.1f}, {turns['fp32'][1]:.1f}, "
          f"{turns['bf16'][1]:.1f}")
    return {"agreement": agree, "img_s_in_turns": turns,
            "nms_input_dtypes": sorted({str(v) for v in seen.values()})}


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
    ssd["bf16_islands"] = phase_ssd_islands(PATHS["ssd"][0])
    fused_rows, fused_launches, fused = phase_fused(fma_per_s, unfused)
    v3_rows, v3_launches, v3 = phase_mnv3(fma_per_s)
    compiled = phase_compiled()
    serving = phase_serving()
    bench = phase_benchmark()
    r50_rows, r50_launches, r50, compiled["resnet50"] = phase_resnet(fma_per_s)
    db_rows, db_launches, db, compiled["dbnet"] = phase_dbnet(fma_per_s)
    rec_rows, rec_launches, rec, compiled["crnn"] = phase_crnn(fma_per_s)
    all_rows = rows + ssd_rows + fused_rows + v3_rows + r50_rows + db_rows + rec_rows
    kernels = _kernel_line(all_rows, {"mobilenet_v1": launches, "ssd": ssd_launches,
                                      "mobilenet_v1_fused": fused_launches,
                                      "mobilenet_v3": v3_launches,
                                      "serving": serving["launches"],
                                      "resnet50": r50_launches, "dbnet": db_launches,
                                      "crnn": rec_launches},
                           {"mobilenet_v1": e2e["profile"]["int8"],
                            "ssd": ssd["profile"]["int8"],
                            "mobilenet_v1_fused": fused["profile"]["int8"],
                            "mobilenet_v3": v3["profile"]["int8"],
                            "resnet50": r50["profile"]["int8"],
                            "dbnet": db["profile"]["int8"],
                            "crnn": rec["profile"]["int8"]})
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
                       "mobilenet_v3": v3, "resnet50": r50, "dbnet": db, "crnn": rec,
                       "compiled": compiled,
                       "serving": serving,
                       "benchmark": bench, "kernels": kernels}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
