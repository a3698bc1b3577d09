"""Test the depthwise kernel's tiling choices and its hard_swish division
on the card.

    python3 -m paddle_lite_tpu_torch.tools.dw_plan_study [--reps 25]

``ops/kernels/depthwise.plan`` picks a tile by a cost estimate with a few
constants, within the shared memory the kernel's layout allows a block;
the VARIANTS below make the plan without the constants, and with blocks
held to 100 KB.  ``csrc/dw_conv.cu`` divides hard_swish by a checked reciprocal;
the variant ``ieee_division`` is the same source built with
``CHECKED_DIVISION = false`` (the IEEE division of ``plt::apply_act``).  At
every depthwise shape of the paths that ``chip_smoke.py`` drives
(MobileNetV1 b64/224, SSD-300 b32, MobileNetV3-Large b64/224; the fused
path's shapes are MobileNetV1's) where a variant differs (another plan, or
hard_swish), it checks the kernel as it is and as the variant against the
plain version, bit for bit, and times both: CUDA events around replays of
a one-call CUDA graph, median of `reps`, as ``chip_smoke.py`` times
kernels, in turns (kernel, variant, variant, kernel) and averaged over the
two turns of each.  It prints each such shape's two plans and times and,
for each variant, the sums over one request of each path.  int8 out, the
activation each graph gives the layer.  Needs one CUDA card and nvcc;
exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels import depthwise as kd

# name: (the layout's smem_per_block or None, module constants of
# ops/kernels/depthwise.py that the variant sets)
VARIANTS = {
    "no_tile_costs": (None, {"TILE_COST": 0.0, "UNITS_PER_PIECE": 0.0}),
    "smem_100k": (100 * 1024, {}),
}
ACTS = ("relu", "relu6", "hard_swish")
CHECKED = "constexpr bool CHECKED_DIVISION = true;"


def path_shapes():
    """{path: {(N, H, W, C, k, s, act): launches a request}}, read off the
    models' graphs (the activation is the op after the depthwise conv's
    batch norm)."""
    from ..models import mobilenet_v1, mobilenet_v3, ssd

    graphs = {"mobilenet_v1": mobilenet_v1.build(batch=64, image_size=224, seed=0),
              "ssd": ssd.build(batch=32, image_size=300, num_classes=21, seed=0),
              "mobilenet_v3": mobilenet_v3.build(batch=64, image_size=224, seed=0,
                                                 with_softmax=False)}
    out = {}
    for path, g in graphs.items():
        ops, counts = g.topological_order(), {}
        for i, op in enumerate(ops):
            if op.op_type != "depthwise_conv2d":
                continue
            n, h, w, c = g.vars[op.input("Input")].shape
            k = g.vars[op.input("Filter")].shape[0]
            after = ops[i + 2].op_type if i + 2 < len(ops) else None
            key = (n, h, w, c, k, int(op.attrs["strides"][0]), after if after in ACTS else None)
            counts[key] = counts.get(key, 0) + 1
        out[path] = counts
    return out


def _median_ms(call, reps):
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        call()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def start_ieee_build():
    """nvcc of dw_conv.cu with CHECKED_DIVISION = false, started; returns
    (library path, process)."""
    src = (_build.CSRC / "dw_conv.cu").read_text()
    if src.count(CHECKED) != 1:
        sys.exit(f"dw_plan_study: dw_conv.cu does not hold {CHECKED!r} once")
    out = _build.BUILD_DIR / "study"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "dw_conv_ieee.cu", out / "libdw_conv_ieee.so"
    cu.write_text(src.replace(CHECKED, "constexpr bool CHECKED_DIVISION = false;"))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)


def load_ieee(so, proc):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        sys.exit(f"dw_plan_study: nvcc failed for the IEEE-division build:\n{log}")
    lib = ctypes.CDLL(str(so))
    _build._declare("dw_conv", lib)
    _build.check(lib.plt_dw_conv_prepare(), "dw_conv prepare (IEEE division)")
    return lib


def _with(setup, fn):
    """fn() with the wrapper's plan and library fixed to setup = (plan, lib)."""
    pl, lib = setup
    real_plan, real_lib = kd.plan, _build._LIBS["dw_conv"]
    kd.plan, _build._LIBS["dw_conv"] = (lambda *a, **k: pl), lib
    try:
        return fn()
    finally:
        kd.plan, _build._LIBS["dw_conv"] = real_plan, real_lib


def _graph(setup, fn):
    for _ in range(3):
        _with(setup, fn)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        _with(setup, fn)
    g.replay()
    return g


def plan_with(shape, lay, consts):
    """depthwise.plan at `shape` with the module constants `consts` set."""
    saved = {name: getattr(kd, name) for name in consts}
    try:
        for name, v in consts.items():
            setattr(kd, name, v)
        kd.plan.cache_clear()
        return kd.plan(*shape, lay)
    finally:
        for name, v in saved.items():
            setattr(kd, name, v)
        kd.plan.cache_clear()


def study_shape(rng, shape, act, setups, reps):
    """Checks and times the kernel at `shape` in each (plan, library) of
    `setups` (the first the kernel as it is); returns their times, in
    turns, and their outputs' mismatches."""
    n, h, w, c, k, s = shape
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)).to(dev)
    wt = torch.from_numpy(rng.integers(-127, 128, (k, k, 1, c), dtype=np.int8)).to(dev)
    eff = torch.from_numpy(rng.uniform(1e-3, 2e-3, c).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)).to(dev)
    y = kd.dw_conv_int8_plain(x, wt, eff, bias, stride=s, act=act)
    kw = dict(stride=s, act=act, out_scale=float(y.abs().max()) / 127 * 0.75)
    ref = kd.dw_conv_int8_plain(x, wt, eff, bias, **kw)
    bad = []
    for setup in setups:
        got = _with(setup, lambda: kd.dw_conv_int8(x, wt, eff, bias, **kw))
        bad.append(int((got != ref).sum()))
    graphs = [_graph(st, lambda: kd.dw_conv_int8(x, wt, eff, bias, **kw)) for st in setups]
    order = list(range(len(setups))) + list(reversed(range(len(setups))))
    times = [[] for _ in setups]
    for i in order:
        times[i].append(_median_ms(graphs[i].replay, reps))
    return [sum(t) / len(t) for t in times], bad


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dw_plan_study: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    ieee_build = start_ieee_build()  # beside the kernels' own build
    lays = {k: kd.layout(k) for k in (3, 5)}
    lib, ieee = _build.load("dw_conv"), load_ieee(*ieee_build)
    for k, lay in lays.items():
        print(f"layout k={k}: {lay}")
    shapes = path_shapes()
    rng = np.random.default_rng(0)
    sums = {}  # (variant, path) -> [changed shapes, plan ms, variant ms]
    failed = 0
    for full in sorted({key for counts in shapes.values() for key in counts}):
        shape, act = full[:6], full[6]
        lay = lays[shape[4]]
        base = plan_with(shape, lay, {})
        variants = {name: (plan_with(shape, lay if smem is None else
                                     lay._replace(smem_per_block=smem), consts), lib)
                    for name, (smem, consts) in VARIANTS.items()}
        variants["ieee_division"] = (base, ieee if act == "hard_swish" else lib)
        for name, (other, other_lib) in variants.items():
            if (other, other_lib) == (base, lib):
                continue
            (t0, t1), bad = study_shape(rng, shape, act, [(base, lib), (other, other_lib)],
                                        args.reps)
            failed += sum(bad)
            print(f"{name:13s} {str(shape):26s} {str(act):10s} plan {t0:.4f} ms "
                  f"{tuple(base)} | variant {t1:.4f} ms {tuple(other)} "
                  f"(x{t1 / t0:.3f}) mismatches {bad}")
            for path, counts in shapes.items():
                if full in counts:
                    acc = sums.setdefault((name, path), [0, 0.0, 0.0])
                    acc[0] += counts[full]
                    acc[1] += counts[full] * t0
                    acc[2] += counts[full] * t1
    print("a request's launches that the variant changes, and their ms as "
          "the kernel is and as the variant:")
    for name in list(VARIANTS) + ["ieee_division"]:
        for path in shapes:
            n, a, b = sums.get((name, path), [0, 0.0, 0.0])
            ratio = f"x{b / a:.3f}" if a else "-"
            print(f"  {name:13s} {path:13s} {n:2d} launches: plan {a:.4f} ms, "
                  f"variant {b:.4f} ms ({ratio})")
    if failed:
        sys.exit(f"dw_plan_study: {failed} outputs differ from the plain version")


if __name__ == "__main__":
    main()
