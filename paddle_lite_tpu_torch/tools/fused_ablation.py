"""What each part of the fused dw+pw kernel's design is worth, on the card.

    python3 -m paddle_lite_tpu_torch.tools.fused_ablation

Builds ``csrc/dw_pw_fused.cu`` and variants of it, each with one part of
the design replaced by a source substitution (one nvcc per variant, started
together, into ``_build/ablation_fused/``), and times every variant at the
same plan on the two fused shapes of MobileNetV1 b64/224 and on one with a
hard_swish pointwise activation: ten launches in one CUDA graph, so the
graph's launch floor is spread over them (µs a launch, median of 15
replays).  Variants (the switches are the constants marked "ablation" in
the source):

- ``with_conversions``: the stencil's and the product's integer sums to
  floats by ``I2F``, the requant by ``plt::requant`` (rintf, F2I);
- ``act_switch``: ``plt::apply_act``'s runtime switch on the activation for
  every element, hard_swish's IEEE division;
- ``one_stage``: a tile's halo copied, waited for, then computed (no copy
  in flight during the compute);
- ``scattered_stores``: two outputs a store from the accumulators, 8 rows
  a warp store, instead of staged whole-row pieces;
- ``fp32_stencil``: the stencil's sums by 9 fp32 FMAs an output on bytes
  turned into floats by ``plt::to_f32x4`` (as ``dw_conv.cu``), instead of
  3 ``__dp4a`` on byte windows;
- ``threads256``: 256 threads a block instead of 512.

Each of these computes the same function and is held bit for bit to the
plain version before it is timed.  Where a launch's time goes is read off
variants with one phase taken out, whose outputs are wrong and only timed:
``no_fetch`` (no halo copies after the first tile's), ``no_stencil``,
``no_product`` (neither the product nor its epilogue), ``no_store``,
``pw_no_mma`` (the epilogue on zero accumulators: no fragment loads, no
``mma.sync``) and ``pw_no_epilogue`` (the accumulators staged as they are).
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
from ..ops.kernels import dw_pw_fused as kf
from ..ops.kernels.int8_matmul import act_args, inv_out_scale

# (N, H, W, C, O, dw act, pw act)
SHAPES = [(64, 112, 112, 32, 64, "relu", "relu"), (64, 56, 56, 128, 128, "relu", "relu"),
          (64, 56, 56, 128, 128, "relu", "hard_swish")]


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        sys.exit(f"fused_ablation: dw_pw_fused.cu does not hold {old!r} once")
    return src.replace(old, new)


def variants(src: str) -> dict:
    def off(flag):
        return _sub(src, f"constexpr bool {flag} = true;", f"constexpr bool {flag} = false;")

    return {"base": src, "with_conversions": off("CONVERSION_FREE"),
            "act_switch": off("ACT_FIXED"), "one_stage": off("PIPELINED"),
            "scattered_stores": off("STAGED_STORES"), "fp32_stencil": off("STENCIL_DP4A"),
            "threads256": _sub(src, "constexpr int THREADS = 512;", "constexpr int THREADS = 256;"),
            "no_fetch": _sub(src, "      if (more) fetch(a, smem + ((it + 1) & 1) * a.slab_bytes, next);\n      cp_async_commit();\n      cp_async_wait<1>();",
                             "      if (a.N < 0) fetch(a, smem + ((it + 1) & 1) * a.slab_bytes, next);\n      cp_async_commit();\n      cp_async_wait<1>();"),
            "no_stencil": _sub(src, "      stencil<DW_ACT>(a,", "      if (a.N < 0) stencil<DW_ACT>(a,"),
            "no_product": _sub(src, "        pointwise<OUT_I8>(a, sm,", "        if (a.N < 0) pointwise<OUT_I8>(a, sm,"),
            "no_store": _sub(src, "          store<OUT_I8>(a, sm.stage, s);", "          if (a.N < 0) store<OUT_I8>(a, sm.stage, s);"),
            "pw_no_mma": _sub(src, "    switch (a.kp) {  // the product's depth", "    if (a.N < 0) switch (a.kp) {  // the product's depth"),
            "pw_no_epilogue": _sub(_sub(_sub(
                src, "        const float y0 = act<ACT, FAST>(acc_to_f32(acc[mi][ni][2 * hf]) * sc.x + bi.x,\n"
                     "                                        a.pw_act, rb, bad);",
                "        const float y0 = __int_as_float(acc[mi][ni][2 * hf]);"),
                "        const float y1 = act<ACT, FAST>(acc_to_f32(acc[mi][ni][2 * hf + 1]) * sc.y + bi.y,\n"
                "                                        a.pw_act, rb, bad);",
                "        const float y1 = __int_as_float(acc[mi][ni][2 * hf + 1]);"),
                "requant_byte<nonnegative<ACT>()>(y0, a.inv_out),\n"
                "                requant_byte<nonnegative<ACT>()>(y1, a.inv_out), 0x0040));",
                "__float_as_uint(y0), __float_as_uint(y1), 0x0040));")}
# variants whose outputs are wrong by design: timed, not compared
PARTS = ("no_fetch", "no_stencil", "no_product", "no_store", "pw_no_mma",
         "pw_no_epilogue")


def build(srcs: dict) -> dict:
    out_dir = _build.BUILD_DIR / "ablation_fused"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in srcs.items():
        cu = out_dir / f"dw_pw_fused_{name}.cu"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out_dir / f"lib{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"fused_ablation: nvcc failed for {name}:\n{log[-3000:]}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
        regs = sorted({ln.split("Used ")[1].split(" ")[0] for ln in log.splitlines()
                       if "Used " in ln and "registers" in ln})
        print(json.dumps({"variant": name, "registers": regs, "spills": spills}))
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        _build._declare("dw_pw_fused", lib)
        _build.check(lib.plt_dw_pw_fused_prepare(), f"{name} prepare")
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
        sys.exit("fused_ablation: needs a CUDA card")
    libs = build(variants((_build.CSRC / "dw_pw_fused.cu").read_text()))
    dev = torch.device("cuda")
    lay = kf.layout()
    rng = np.random.default_rng(0)
    bad = 0
    for n, h, w, c, o, dw_act, pw_act in SHAPES:
        def rand8(*shape):
            return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)

        def randf(lo, hi, k):
            return torch.from_numpy(rng.uniform(lo, hi, k).astype(np.float32)).to(dev)

        x, dw, pw = rand8(n, h, w, c), rand8(3, 3, 1, c), rand8(c, o)
        pw_nk = pw.t().contiguous()
        dw_s, dw_b, pw_s, pw_b = randf(1e-3, 2e-3, c), randf(-.5, .5, c), randf(1e-3, 2e-3, o), randf(-.5, .5, o)
        ref = kf.fused_dw_pw_int8_plain(x, dw, dw_s, dw_b, 0.05, pw, pw_s, pw_b, dw_act=dw_act,
                                        pw_act=pw_act, pw_out_scale=0.1)
        out = torch.empty_like(ref)
        p = kf.plan(n, h, w, c, o, True, lay)
        row = {"shape": [n, h, w, c, o], "acts": f"{dw_act}/{pw_act}", "plan": p._asdict()}
        for name, lib in libs.items():
            def call(lib=lib):
                _build.check(lib.plt_dw_pw_fused(
                    x.data_ptr(), dw.data_ptr(), dw_s.data_ptr(), dw_b.data_ptr(),
                    *act_args(dw_act), inv_out_scale(0.05), pw_nk.data_ptr(), pw_s.data_ptr(),
                    pw_b.data_ptr(), *act_args(pw_act), 1, inv_out_scale(0.1), out.data_ptr(),
                    n, h, w, c, o, p.rows, p.tw, p.twp, p.sub, p.oc, p.vec_bytes,
                    p.out_width, p.smem_bytes, p.tiles, p.blocks,
                    torch.cuda.current_stream().cuda_stream), name)

            out.zero_()
            call()
            torch.cuda.synchronize()
            mismatch = int((out != ref).sum())
            if name not in PARTS:
                bad += mismatch
            row[f"{name}_us"] = round(time_us(call), 1)
            row[f"{name}_mismatch"] = mismatch
        print(json.dumps(row))
    if bad:
        sys.exit(f"fused_ablation: {bad} outputs differ from the plain version")


if __name__ == "__main__":
    main()
