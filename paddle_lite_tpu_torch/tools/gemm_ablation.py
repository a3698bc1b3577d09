"""What each part of the int8 GEMM kernel is worth, on the card.

    python3 -m paddle_lite_tpu_torch.tools.gemm_ablation

Builds ``csrc/int8_gemm.cu`` and variants of it, each with one part taken
out or replaced by a source substitution (one nvcc per variant, started
together, into ``_build/ablation/``), and times every variant at the same
plan on shapes of the MobileNetV1, SSD and MobileNetV3 paths: ten launches
in one CUDA graph, so the graph's launch floor is spread over them (µs a
launch, median of 15 replays).  Variants:

- ``no_copy``: no copies (products of whatever the ring holds);
- ``no_epi``: no epilogue and no stores;
- ``mma_only``: neither;
- ``ieee_div``: hard_swish's IEEE division instead of the checked one;
- ``with_conversions``: int->float by ``I2F`` and the int8 out by
  ``plt::requant`` instead of the conversion-free arithmetic.

The variants without copies or epilogue compute wrong outputs; only their
times are read.  Also prints ``torch._int_mm`` on the (N, K) weight,
transposed, as a yardstick.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels import int8_matmul as km

# (M, K, N, plt::Act code): relu, or hard_swish (code 4) for its division
SHAPES = [(802816, 32, 64, 1), (200704, 128, 128, 1), (50176, 256, 256, 1),
          (12544, 512, 512, 1), (3136, 1024, 1024, 1), (200704, 24, 72, 1),
          (50176, 40, 240, 4), (12544, 112, 672, 4)]
HARD_SWISH = (6.0, 6.0, 3.0)  # threshold, scale, offset


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        sys.exit(f"gemm_ablation: int8_gemm.cu does not hold {old!r} once")
    return src.replace(old, new)


def variants(src: str) -> dict:
    def no_copy(s):
        s = _sub(s, "    if (i + STAGES - 1 < total) load(i + STAGES - 1);",
                 "    if (K < 0) load(i + STAGES - 1);")
        return _sub(s, "    if (s < total) load(s);", "    if (K < 0) load(s);")

    def no_epi(s):
        return _sub(s, "    to_float_bits(acc, K <= SMALL_K);",
                    "    if (K > 0) continue;\n    to_float_bits(acc, K <= SMALL_K);")

    conv = _sub(_sub(src, "to_float_bits(acc, K <= SMALL_K);", "to_float_bits(acc, false);"),
                "plt::requant_lo(y0, inv_out_scale), plt::requant_lo(y1, inv_out_scale), 0x0040",
                "(uint32_t)(uint8_t)plt::requant(y0, inv_out_scale), "
                "(uint32_t)(uint8_t)plt::requant(y1, inv_out_scale), 0x0040")
    return {"base": src, "no_copy": no_copy(src), "no_epi": no_epi(src),
            "mma_only": no_epi(no_copy(src)),
            "ieee_div": _sub(src, "const bool fast_div = act.code == plt::ACT_HARD_SWISH &&",
                             "const bool fast_div = false &&"),
            "with_conversions": conv}


def build(srcs: dict) -> dict:
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in srcs.items():
        cu = out_dir / f"int8_gemm_{name}.cu"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out_dir / f"lib{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"gemm_ablation: nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        _build._declare("int8_gemm", lib)
        _build.check(lib.plt_int8_gemm_prepare(), f"{name} prepare")
        libs[name] = lib
    return libs


def time_us(fn, reps: int = 15, inner: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        graph.replay()
        e.record()
    torch.cuda.synchronize()
    return 1e3 * statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends)) / inner


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("gemm_ablation: needs a CUDA card")
    libs = build(variants((_build.CSRC / "int8_gemm.cu").read_text()))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    for m, k, n, act in SHAPES:
        x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(dev)
        w_nk = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(dev)
        scale = torch.full((n,), 1e-4, device=dev)
        out = torch.empty((m, n), dtype=torch.int8, device=dev)
        p = km.plan(m, k, n, True)
        row = {"shape": [m, k, n], "act": act, "plan": p._asdict()}
        for name, lib in libs.items():
            per_sm = ctypes.c_int()
            _build.check(lib.plt_int8_gemm_occupancy(p.bn, p.warpgroups, 1, 0, p.smem_bytes,
                                                     ctypes.byref(per_sm)), "occupancy")
            blocks = min(p.tiles, per_sm.value * sms)

            def call(lib=lib, blocks=blocks):
                _build.check(lib.plt_int8_gemm(
                    x.data_ptr(), w_nk.data_ptr(), scale.data_ptr(), None, out.data_ptr(),
                    m, n, k, act, *HARD_SWISH, 1, 20.0, None, 0.0, p.bn, p.bk, p.warpgroups,
                    p.width, p.out_width, p.smem_bytes, blocks,
                    torch.cuda.current_stream().cuda_stream), "int8_gemm")

            row[f"{name}_us"] = round(time_us(call), 1)
        row["int_mm_nk_us"] = round(time_us(lambda: torch._int_mm(x, w_nk.t())), 1)
        print(json.dumps(row))


if __name__ == "__main__":
    main()
