"""Per-shape int8 GEMM roofline report on the card.

Port of ``paddle_lite_tpu/tools/gemm_roofline.py``.  For every GEMM shape a
zoo model gives the kernel, it times both implementations, the hand-written
kernel (``csrc/int8_gemm.cu`` through ``int8_matmul``) and ``torch._int_mm``
followed by the same epilogue in torch (scale, bias, relu, requant: the
reference's "XLA dot+epilogue" column), and sets them beside the shape's
analytic ceiling:

    t_compute = 2·m·k·n / int8 peak
    t_memory  = (m·k + k·n + m·n bytes, int8 in / int8 or fp32 out) / memory rate
    t_roof    = max(t_compute, t_memory)

with the peaks from ``utils/device_info`` for the card it runs on.  Each
time is CUDA events around replays of a CUDA graph of ``CALLS`` calls
(median of ``REPS``), so the host's dispatch is not counted and the graph's
launch floor is spread over the calls.  ``torch._int_mm`` takes M > 16 and
K, N multiples of 8; a shape outside that has no library time.

    python -m paddle_lite_tpu_torch.tools.gemm_roofline [--models mobilenet_v1,ernie_tiny]
        [--shapes MxKxN,...] [--fp32-out]

The shapes are read off the zoo graphs (the reference reads
``.autotune/gemm.json``, a table measured on a TPU, which the port never
reads): every op the optimized int8 graph tags ``"cuda"`` for the GEMM.
Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import List, Tuple

import numpy as np
import torch

from ..utils import device_info

CALLS, REPS = 10, 25
MODEL_BATCH = {"mobilenet_v1": 64, "ernie_tiny": 32, "ssd": 32, "resnet": 32,
               "mobilenet_v3": 64}


def _time_ms(fn) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    for s, e in zip(starts, ends):
        s.record()
        graph.replay()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends)) / CALLS


def measure_shape(m: int, k: int, n: int, *, out_int8: bool = True) -> dict:
    """The kernel and ``_int_mm`` + epilogue at (m, k, n) on the card, the
    kernel checked against its plain version first."""
    from ..ops.kernels import int8_matmul as km

    dev = torch.device("cuda", torch.cuda.current_device())
    info = device_info.get(dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(dev)
    w_nk = w.t().contiguous()
    eff = torch.from_numpy(rng.uniform(1e-3, 2e-3, (n,)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(dev)
    out_scale = 0.05 if out_int8 else None
    kw = dict(act="relu", out_scale=out_scale)

    def one_kernel():
        return km.int8_matmul(x, w, eff, bias, w_nk=w_nk, **kw)

    got, ref = one_kernel(), km.int8_matmul_plain(x, w, eff, bias, **kw)
    if not torch.equal(got, ref):
        raise AssertionError(f"gemm_roofline: the kernel differs from its plain version "
                             f"at {m}x{k}x{n}")
    t_k = _time_ms(one_kernel)
    t_l = None
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        t_l = _time_ms(lambda: km.epilogue(torch._int_mm(x, w).to(torch.float32), eff, bias,
                                           "relu", None, out_scale))
    flops = 2.0 * m * k * n
    mem_bytes = m * k + k * n + m * n * (1 if out_int8 else 4)
    t_compute = flops / info.int8_ops_per_s()
    t_memory = mem_bytes / info.hbm_bytes_per_s()
    t_roof = max(t_compute, t_memory)
    best = min(t_k, t_l) if t_l is not None else t_k
    return {
        "shape": f"{m}x{k}x{n}",
        "out": "int8" if out_int8 else "fp32",
        "bound": "compute" if t_compute >= t_memory else "memory",
        "roof_us": t_roof * 1e6,
        "kernel_us": t_k * 1e3,
        "library_us": None if t_l is None else t_l * 1e3,
        "kernel_tops": flops / (t_k * 1e-3) / 1e12,
        "library_tops": None if t_l is None else flops / (t_l * 1e-3) / 1e12,
        "best_pct_of_roofline": 100 * t_roof / (best * 1e-3),
        "winner": "kernel" if t_l is None or t_k < t_l else "library",
    }


def gemm_shapes(graph) -> List[Tuple[int, int, int, bool]]:
    """(M, K, N, int8 out) of every op the optimized `graph` gives the
    GEMM: fc, mul, and a conv as its im2col rows (M = N·OH·OW, K =
    kh·kw·C), in graph order, each once."""
    out = []
    for op in graph.topological_order():
        if op.attrs.get("kernel") != "cuda":
            continue
        i8 = op.attrs.get("out_scale") is not None
        if op.op_type == "conv2d":
            kh, kw, c, oc = graph.vars[op.input("Filter")].shape
            n, oh, ow, _ = graph.vars[op.output("Output")].shape
            shape = (n * oh * ow, kh * kw * c, oc, i8)
        elif op.op_type == "fc":
            x = graph.vars[op.input("Input")].shape
            ncd = int(op.attrs.get("in_num_col_dims", len(x) - 1))
            k, n = graph.vars[op.input("W")].shape
            shape = (int(np.prod(x[:ncd])), k, n, i8)
        elif op.op_type == "mul":
            x, w = graph.vars[op.input("X")].shape, graph.vars[op.input("Y")].shape
            xd, yd = int(op.attrs.get("x_num_col_dims", 1)), int(op.attrs.get("y_num_col_dims", 1))
            shape = (int(np.prod(x[:xd])), int(np.prod(x[xd:])), int(np.prod(w[yd:])), i8)
        else:
            continue
        if shape not in out:
            out.append(shape)
    return out


def zoo_shapes(model: str, *, batch: int = None, device=None) -> List[Tuple[int, int, int, bool]]:
    """:func:`gemm_shapes` of the zoo `model` at its serving batch, built,
    calibrated on one seeded batch and optimized with its zoo config."""
    from ..models.zoo_config import recommended_quant
    from .benchmark import resolve_builder
    from .opt import optimize
    from .profile import model_feed

    batch = batch or MODEL_BATCH.get(model, 32)
    build = resolve_builder(model)
    g = build(batch=batch, seq_len=128) if model == "ernie_tiny" else build(batch=batch)
    optimize(g, quant=recommended_quant(model), calib_batches=[model_feed(g)], device=device)
    return gemm_shapes(g)


def main() -> None:
    from .benchmark import card

    p = argparse.ArgumentParser()
    p.add_argument("--models", default="mobilenet_v1,ernie_tiny",
                   help="zoo models whose GEMM shapes are measured")
    p.add_argument("--shapes", default=None, help="MxKxN[,MxKxN...] instead of --models")
    p.add_argument("--fp32-out", action="store_true",
                   help="with --shapes: fp32 outputs (the zoo shapes keep their own)")
    args = p.parse_args()
    print(json.dumps({"device": card(torch.device("cuda"))}))
    if args.shapes:
        shapes = [tuple(int(v) for v in s.split("x")) + (not args.fp32_out,)
                  for s in args.shapes.split(",")]
    else:
        shapes = []
        for model in args.models.split(","):
            shapes += [s for s in zoo_shapes(model) if s not in shapes]
    for m, k, n, i8 in shapes:
        print(json.dumps(measure_shape(m, k, n, out_int8=i8)), flush=True)


if __name__ == "__main__":
    main()
