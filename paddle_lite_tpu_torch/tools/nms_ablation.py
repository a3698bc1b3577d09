"""What each part of the NMS kernel's design is worth, on the card.

    python3 -m paddle_lite_tpu_torch.tools.nms_ablation

Builds ``csrc/nms.cu`` and variants of it, each with one part of the
design replaced by a source substitution (one nvcc per variant, started
together, into ``_build/ablation_nms/``), and times every variant at SSD's
shape, G = 672 instances (32 images x 21 classes) of k = 528 candidates:
ten launches in one CUDA graph, so the graph's launch floor is spread over
them (µs a launch, median of 15 replays).  The candidates are a seeded
stand-in with SSD's counts: every candidate valid, boxes sized so that
about 69 % are kept (chip_smoke.py's ``ssd_bucket3`` row keeps 69 %).
Variants (the switches are the constants marked "ablation" in the
source):

- ``shared_sort``: every stride of the bitonic sort through shared
  memory, a barrier each;
- ``one_network``: all P keys (1024 at k = 528) in one bitonic network,
  instead of k's largest power of two and the rest (512 and 256) apart,
  merged by ranks;
- ``select_bits``: the pair test's bit set by the compiler's select and
  add instead of a predicated OR;
- ``two_clamps``: the pair test with both of ``ix``'s and ``iy``'s clamps
  at 0, as the reference writes it (the kernel leaves out ``iy``'s where
  ``iou_t >= 0``, which changes no bit).

Each of these computes the same function and is held bit for bit to the
plain version before it is timed.  Where a launch's time goes is read off
variants with one phase taken out, whose outputs are wrong and only timed:
``no_sort`` (candidates taken in slot order), ``no_mask`` (every pair test
false, so every valid rank is kept and tested) and ``no_settle`` (a word's
ranks not settled against its diagonal tile).
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
from ..ops.kernels import nms as kn

G, K = 672, 528
IOU_T, SCORE_T = 0.45, 0.01


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        sys.exit(f"nms_ablation: nms.cu does not hold {old!r} once")
    return src.replace(old, new)


def variants(src: str) -> dict:
    def off(flag):
        return _sub(src, f"constexpr bool {flag} = true;", f"constexpr bool {flag} = false;")

    return {"base": src, "shared_sort": off("REGISTER_SORT"), "one_network": off("SPLIT_SORT"),
            "select_bits": off("PREDICATED_OR"),
            "two_clamps": src.replace("iou_t >= 0.0f ? ", "false ? "),
            "no_sort": _sub(_sub(src, "  sort_keys<J>(v, key, L.sort_n, sp, tid);\n", ""),
                            "  const SortSplit sp = sort_split(k, L.sort_n, J);",
                            "  const SortSplit sp = {L.sort_n, 0};"),
            "no_mask": _sub(src, "  return bits;\n}\n\n// The 32 bits of row `lane` of diagonal",
                            "  return 0u * bits;\n}\n\n// The 32 bits of row `lane` of diagonal"),
            "no_settle": _sub(src, "~settle(rem[u], diag[32 * u + lane])", "~rem[u]")}
# variants whose outputs are wrong by design: timed, not compared
PARTS = ("no_sort", "no_mask", "no_settle")


def build(srcs: dict) -> dict:
    out_dir = _build.BUILD_DIR / "ablation_nms"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in srcs.items():
        cu = out_dir / f"nms_{name}.cu"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nms_ablation: nvcc failed for {name}:\n{log[-3000:]}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
        regs = sorted({ln.split("Used ")[1].split(" ")[0] for ln in log.splitlines()
                       if "Used " in ln and "registers" in ln})
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        _build._declare("nms", lib)
        _build.check(lib.plt_nms_prepare(), f"{name} prepare")
        vals = [ctypes.c_int() for _ in kn.Layout._fields]
        _build.check(lib.plt_nms_layout(*[ctypes.byref(v) for v in vals]), f"{name} layout")
        lay = kn.Layout(*(v.value for v in vals))
        smem = lib.plt_nms_smem_bytes(K)
        bps = min(lay.blocks_per_sm, lay.smem_per_sm // (smem + lay.smem_reserved))
        print(json.dumps({"variant": name, "registers": regs, "spills": spills,
                          "smem_bytes": smem, "blocks_per_sm": bps,
                          "waves": G / (lay.sms * bps)}))
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


def stand_in(seed: int = 0):
    """(G, K, 4) boxes and (G, K) scores on the card: every candidate
    valid, about 69 % kept."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 1.0, (G, K, 2))
    wh = rng.uniform(0.02, 0.34, (G, K, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.02, 1.0, (G, K)).astype(np.float32)
    dev = torch.device("cuda")
    return torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("nms_ablation: needs a CUDA card")
    libs = build(variants((_build.CSRC / "nms.cu").read_text()))
    boxes, scores = stand_in()
    ref = kn.nms_keep_scores_plain(boxes, scores, iou_t=IOU_T, score_t=SCORE_T)
    out = torch.empty_like(ref)
    iou, st = float(np.float32(IOU_T)), float(np.float32(SCORE_T))
    row = {"shape": [G, K], "kept": int((ref > 0).sum()), "valid": int((scores > st).sum())}
    bad = 0
    for name, lib in libs.items():
        def call(lib=lib):
            _build.check(lib.plt_nms_keep(boxes.data_ptr(), scores.data_ptr(), out.data_ptr(),
                                          G, K, iou, st, 0,
                                          torch.cuda.current_stream().cuda_stream), name)

        out.fill_(-1.0)
        call()
        torch.cuda.synchronize()
        mismatch = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
        if name not in PARTS:
            bad += mismatch
        row[f"{name}_us"] = round(time_us(call), 2)
        row[f"{name}_mismatch"] = mismatch
    print(json.dumps(row))
    if bad:
        sys.exit(f"nms_ablation: {bad} outputs differ from the plain version")


if __name__ == "__main__":
    main()
