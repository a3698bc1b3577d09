"""The kernel table measured on the card.

Port of ``paddle_lite_tpu/ops/kernels/tune_cache.py``.  The reference
times its Pallas kernels against the XLA lowering on a TPU and keeps the
winner of each shape bucket; ``kernel_pick`` reads it.  Here the same
table holds, for each bucket, whether the hand-written CUDA kernel
(``"cuda"``) or the op's plain PyTorch impl (``"torch"``) is faster on the
card, and for a GEMM bucket the kernel's fastest plan (``"blocks:" +
key``).  ``select.choose_kernel`` reads it.

- **Keys.** :func:`_bucket`, :func:`_key` and :func:`_dw_key` are the
  reference's, so a shape falls in the same bucket in both packages.  A
  GEMM's problem is ``autotune._gemm_problem``'s (m, k, n); a depthwise
  conv's is (H, C, k, stride).
- **Where it lives.** ``kernels.json`` in the port's own
  ``paddle_lite_tpu_torch/_tuning/`` (listed in ``.gitignore``, beside the
  batch table's ``batch.json``), or in the directory that the environment
  variable ``PLT_TORCH_AUTOTUNE_DIR`` names: the counterpart of the
  reference's ``PLT_TPU_AUTOTUNE_CACHE``.  It never reads or writes the
  reference's ``.autotune/``, whose numbers were taken on a TPU.
- **Entries.** Each records the winner, both times and the card's name and
  power limit (as ``runtime/batch_table`` rows do)::

      {"3072x8192x24": {"winner": "cuda", "cuda_us": 185.7, "torch_us": 391.6,
                        "card": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"},
       "blocks:4096x1024x3072": {"plan": [128, 128, 2], "out_i8": false,
                                 "us": 94.2, "default_plan": [256, 32, 2], ...}}

  A ``"blocks:"`` entry names its output kind by ``"out_i8"``.  No int32
  GEMM (``int8_matmul.OUT_I32``) is swept, so its lookup finds no entry
  and ``int8_matmul.plan`` keeps the heuristic, which is the fp32 plan.

  :func:`validate_in_model` adds the whole model's items/s with and
  without the kernel (``"in_model"``).  The table is read once a path
  (:func:`_load`); :func:`_store` merges entries and writes the file
  through a temporary file and a rename.
- **Measuring.** :func:`measure_gemm` / :func:`measure_dw` (and
  :func:`tune_graph`, op by op) time the kernel against the op's
  ``"torch"`` impl on the same inputs: CUDA events around replays of a
  CUDA graph of one call, median of 25 (:func:`_time_us`).  The reference's
  iteration-delta loop answered the TPU's asynchronous dispatch; a CUDA
  graph's replay needs none of it.  Measuring runs on the card only: on the
  CPU it raises, and nothing falls back to a host clock or the plain
  versions.
- **In-model validation.** A kernel that wins alone is only a candidate:
  :func:`validate_in_model` keeps a ``"cuda"`` bucket only where the whole
  compiled model is ``min_win`` times faster with it, greedily, one bucket
  at a time, and persists the demotions.

Run ``python3 -m paddle_lite_tpu_torch.tools.cli tune --model ssd --batch
32 --validate`` to fill the table for a model's shapes on the card.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

ENV = "PLT_TORCH_AUTOTUNE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / "_tuning"
TABLE = "kernels.json"
REPS = 25  # timed replays a reading (the median is kept)


def table_path() -> Path:
    return Path(os.environ.get(ENV) or DEFAULT_DIR) / TABLE


def _bucket(x: int) -> int:
    """Round to a coarse power-of-two-ish bucket so one measurement covers
    neighboring shapes (two buckets an octave: the reference's)."""
    if x <= 0:
        return 0
    b = 1
    while b * 2 <= x:
        b *= 2
    return b if x < b * 1.5 else int(b * 1.5)


def _key(m: int, k: int, n: int) -> str:
    return f"{_bucket(m)}x{_bucket(k)}x{_bucket(n)}"


def _dw_key(h: int, c: int, k: int = 3, s: int = 1) -> str:
    return f"dw{k}x{k}s{s}_{_bucket(h)}x{_bucket(c)}"


@functools.lru_cache(maxsize=None)
def _read(path: str) -> Dict[str, dict]:
    p = Path(path)
    if not p.is_file():
        return {}
    with open(p) as f:
        return json.load(f)


def _load() -> Dict[str, dict]:
    """The table at :func:`table_path`, read once."""
    return _read(str(table_path()))


def lookup(key: str) -> Optional[str]:
    """The winner measured for `key` ("cuda" or "torch"), None unmeasured."""
    return _load().get(key, {}).get("winner")


def lookup_gemm(m: int, k: int, n: int) -> Optional[str]:
    return lookup(_key(m, k, n))


def lookup_dw(h: int, c: int, k: int = 3, s: int = 1) -> Optional[str]:
    return lookup(_dw_key(h, c, k, s))


def lookup_blocks(m: int, k: int, n: int, out: int) -> Optional[Tuple[int, int, int]]:
    """The swept (bn, bk, warpgroups) of this bucket, if it was swept for
    this output kind (``int8_matmul.OUT_*``; a bool reads as int8 / fp32;
    :func:`sweep_gemm_blocks`); None keeps ``int8_matmul.plan``'s
    heuristic."""
    e = _load().get("blocks:" + _key(m, k, n))
    if not e or int(bool(e["out_i8"])) != int(out):
        return None
    bn, bk, wgs = e["plan"]
    return int(bn), int(bk), int(wgs)


def _store(entries: Dict[str, dict]) -> None:
    """Merge `entries` into the table (fields of an existing entry that an
    entry does not set stay) and write it whole: a temporary file, then a
    rename."""
    p = table_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    table = {k: dict(v) for k, v in _load().items()}
    for k, v in entries.items():
        table.setdefault(k, {}).update(v)
    tmp = p.with_name(f"{TABLE}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    os.replace(tmp, p)
    _read.cache_clear()


# ---- measuring on the card --------------------------------------------------

def _card_device(device):
    """The card to measure on; raises without one (no timing on the CPU)."""
    from ...core.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"tune_cache: kernels are measured on the card, not on {dev}; "
                           f"there is no CPU timing")
    return dev


@functools.lru_cache(maxsize=None)
def _card(device) -> Dict[str, Optional[str]]:
    from ...tools.benchmark import card

    c = card(device)
    return {"card": c["name"], "power_limit": c["power_limit"]}


def _time_us(fn: Callable[[], object], reps: int = REPS, warmup: int = 3) -> float:
    """Median device µs of one call of `fn`: CUDA events around each of
    `reps` replays of a CUDA graph holding the call."""
    import torch

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
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        graph.replay()
        e.record()
    torch.cuda.synchronize()
    return 1e3 * statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _op_inputs(graph, op, device):
    """`op`'s inputs on `device`: its weights staged as the executor stages
    them, every other input drawn at random (seed 0) at its var's shape
    and precision (int8 in [-127, 127])."""
    import numpy as np
    import torch

    from ...core.executor import island_dtype

    rng = np.random.default_rng(0)
    island = island_dtype(graph)
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            v = graph.vars[n]
            if n in graph.weights:
                t = torch.from_numpy(np.ascontiguousarray(graph.weights[n])).to(device)
                if island is not None and t.dtype == torch.float32:
                    t = t.to(island)
            elif v.precision.torch_dtype == torch.int8:
                t = torch.from_numpy(rng.integers(-127, 128, v.shape, dtype=np.int8)).to(device)
            else:
                t = torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)).to(
                    device=device, dtype=v.precision.torch_dtype)
            vals.append(t)
        if vals:
            ins[slot] = vals
    return ins


def _time_op(graph, op, device) -> Dict[str, float]:
    """µs a call of `op` through its ``"cuda"`` and its ``"torch"`` impl on
    the same inputs (TF32 off, as in the model)."""
    from ...core.device import fp32_exact
    from ...core.executor import ExecutionContext
    from ...core.registry import OPS

    ins = _op_inputs(graph, op, device)
    out = {}
    with fp32_exact():
        for tag in ("cuda", "torch"):
            ctx = ExecutionContext(graph=graph, device=device)
            impl = OPS.get(op.op_type).impl_for(tag)
            impl(ctx, op, ins)  # per-op constants, outside the capture
            out[tag] = _time_us(lambda: impl(ctx, op, ins))
    return out


def _measure_op(graph, op, key: str, device, verbose: bool, persist: bool,
                what: str) -> str:
    t = _time_op(graph, op, device)
    winner = "cuda" if t["cuda"] < t["torch"] else "torch"
    if verbose:
        print(f"  {key} {what}: cuda {t['cuda']:.1f} us, torch {t['torch']:.1f} us "
              f"-> {winner}", flush=True)
    if persist:
        _store({key: {"winner": winner, "cuda_us": t["cuda"], "torch_us": t["torch"],
                      **_card(device)}})
    return winner


def _problem_graph(op_type: str, x_shape, w_shape, w_axis: int, attrs: dict, out_shape):
    """A one-op int8 graph: the problem the reference's measurers time
    (relu, int8 out at scale 0.05, effective scales in [1e-3, 2e-3]),
    weights drawn from seed 0."""
    import numpy as np

    from ...core.ir import Graph
    from ...core.types import Precision, QuantInfo

    rng = np.random.default_rng(0)
    g = Graph(f"tune_{op_type}")
    g.add_var("x", x_shape, Precision.INT8).quant = QuantInfo.per_tensor(0.05)
    g.add_weight("w", rng.integers(-127, 128, w_shape, dtype=np.int8)).quant = \
        QuantInfo.per_channel_scales(rng.uniform(0.02, 0.04, w_shape[w_axis]), axis=w_axis)
    g.add_weight("b", rng.normal(size=(w_shape[w_axis],)).astype(np.float32))
    g.add_var("y", out_shape, Precision.INT8)
    slots = {"fc": ("Input", "W", "Out"), "depthwise_conv2d": ("Input", "Filter", "Output")}
    xs, ws, ys = slots[op_type]
    op = g.add_op(op_type, {xs: ["x"], ws: ["w"], "Bias": ["b"]}, {ys: ["y"]},
                  {**attrs, "enable_int8": True, "fuse_act": "relu", "act_attrs": {},
                   "out_scale": 0.05})
    g.inputs, g.outputs = ["x"], ["y"]
    return g, op


def measure_gemm(m: int, k: int, n: int, *, verbose: bool = False, persist: bool = True,
                 device=None) -> str:
    """Time the GEMM kernel against the ``"torch"`` int8 ``fc`` (a float64
    product for the exact accumulator, then the epilogue's passes) at (m, k)
    · (k, n), relu and int8 out, on the card, and store the winner of the
    bucket.  Returns "cuda" or "torch"."""
    dev = _card_device(device)
    g, op = _problem_graph("fc", (m, k), (k, n), 1, {"in_num_col_dims": 1}, (m, n))
    return _measure_op(g, op, _key(m, k, n), dev, verbose, persist, f"({m},{k},{n})")


def measure_dw(batch: int, h: int, c: int, *, k: int = 3, s: int = 1,
               verbose: bool = False, persist: bool = True, device=None) -> str:
    """Time the depthwise kernel against the ``"torch"`` depthwise conv (the
    cuDNN fp32 grouped conv, ``round`` and the epilogue's passes) at
    (batch, h, h, c), k×k, stride s, SAME padding, relu and int8 out, on the
    card, and store the winner of the bucket."""
    from ..common import conv_out_size

    dev = _card_device(device)
    p = (k - 1) // 2
    o = conv_out_size(h, k, s, (p, p), 1)
    g, op = _problem_graph("depthwise_conv2d", (batch, h, h, c), (k, k, 1, c), 3,
                           {"strides": [s, s], "paddings": [p, p], "dilations": [1, 1],
                            "groups": c, "dw_compute": "int32"}, (batch, o, o, c))
    return _measure_op(g, op, _dw_key(h, c, k, s), dev, verbose, persist,
                       f"dw k{k}s{s} ({batch},{h},{c})")


def sweep_gemm_blocks(m: int, k: int, n: int, *, out_i8: bool = True, verbose: bool = False,
                      persist: bool = True, device=None) -> dict:
    """Time every plan of ``autotune.plan_candidates`` for this GEMM (relu;
    int8 out at scale 0.05, or fp32 out) on the card, each first held bit
    for bit to ``int8_matmul_plain`` on the same inputs (a plan that
    differs cannot win), and store the fastest under ``"blocks:" + key``
    with today's plan (``int8_matmul.default_plan``) and its time beside
    it.  Returns {"plan", "us", "default_plan", "default_us",
    "candidates": [{"plan", "us", "exact"}]}."""
    import numpy as np
    import torch

    from . import int8_matmul as mm
    from .autotune import plan_candidates

    dev = _card_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(dev)
    eff = torch.from_numpy(rng.uniform(1e-3, 2e-3, n).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    w_nk = w.t().contiguous()
    kw = dict(act="relu", out_scale=0.05 if out_i8 else None)
    ref = mm.int8_matmul_plain(x, w, eff, bias, **kw)

    def call(p):
        return mm.int8_matmul(x, w, eff, bias, w_nk=w_nk, tiling=p, **kw)

    rows = []
    for cand in plan_candidates(m, k, n, out_i8):
        p = mm.plan_of(m, k, n, out_i8, *cand)
        exact = torch.equal(call(p), ref)
        us = _time_us(lambda: call(p)) if exact else None
        rows.append({"plan": list(cand), "us": us, "exact": exact})
        if verbose:
            print(f"  blocks {cand} ({m},{k},{n}) {'int8' if out_i8 else 'fp32'} out: "
                  + (f"{us:.1f} us ({2 * m * k * n / us / 1e6:.1f} TOP/s)" if exact
                     else "NOT bit-exact, skipped"), flush=True)
    default = mm.default_plan(m, k, n, out_i8)
    default_us = _time_us(lambda: call(default))
    best = min((r for r in rows if r["exact"]), key=lambda r: r["us"])
    out = {"plan": best["plan"], "us": best["us"],
           "default_plan": [default.bn, default.bk, default.warpgroups],
           "default_us": default_us, "candidates": rows}
    if persist:
        _store({"blocks:" + _key(m, k, n): {
            "plan": best["plan"], "out_i8": bool(out_i8), "us": best["us"],
            "default_plan": out["default_plan"], "default_us": default_us, **_card(dev)}})
    return out


# ---- a model's buckets -----------------------------------------------------

def _op_table_key(graph, op) -> Optional[str]:
    """The table key that governs `op`'s kernel pick: a GEMM or depthwise
    op a kernel takes (``autotune._gemm_problem``, ``autotune._dw_problem``
    with an activation the kernel's epilogue computes); None for an op
    whose pick is not table-driven (the NMS kernel's ops, the rest)."""
    from .autotune import _dw_problem, _gemm_problem
    from .int8_matmul import ACTS
    from .select import _kernel_epilogue

    if op.op_type == "depthwise_conv2d":
        prob = _dw_problem(graph, op)
        if prob is None or not _kernel_epilogue(op, ACTS):
            return None
        return _dw_key(*prob)
    prob = _gemm_problem(graph, op)
    return _key(*prob) if prob else None


def tune_graph(graph, *, verbose: bool = False, sweep_blocks: bool = False,
               device=None) -> Dict[str, str]:
    """Measure every table-driven bucket of an optimized graph once, on the
    graph's first op of that bucket (a conv on its GEMM route, as it
    runs): the kernel against the op's ``"torch"`` impl.  With
    ``sweep_blocks`` each GEMM bucket's plans are swept first (at the op's
    output type), so the kernel is timed with its fastest plan.  Returns
    {key: winner}."""
    from ...passes.kernel_pick import int8_activation
    from .autotune import _gemm_problem

    dev = _card_device(device)
    results: Dict[str, str] = {}
    for op in graph.ops:
        key = _op_table_key(graph, op)
        if key is None or key in results or not int8_activation(graph, op):
            continue
        prob = _gemm_problem(graph, op)
        if sweep_blocks and prob is not None:
            sweep_gemm_blocks(*prob, out_i8=op.attrs.get("out_scale") is not None,
                              verbose=verbose, device=dev)
        out = next(iter(op.outputs.values()))[0]
        results[key] = _measure_op(graph, op, key, dev, verbose, True,
                                   f"{op.op_type} {out}")
    return results


def validate_in_model(graph, feed, *, min_win: float = 1.01, persist: bool = True,
                      verbose: bool = False, measure=None) -> Dict[str, str]:
    """The whole model's A/B of every ``"cuda"`` table bucket.

    ``graph`` is optimized (kernel pick applied).  For each bucket whose ops
    are tagged ``"cuda"``, the whole model is measured again with that
    bucket's ops on their ``"torch"`` impl (greedy, one bucket at a time,
    keeping what improves); the kernel survives only if the model is
    ``min_win`` times faster with it, and a tie goes to ``"torch"``.  The
    graph is retagged in place and the decisions persisted with both
    items/s, so ``optimize()`` picks them from then on.  ``measure(graph,
    feed) -> items/s`` defaults to ``tools.benchmark.device_throughput``
    (the compiled graph on the card).  Returns {key: winner}."""
    if measure is None:
        from ...tools.benchmark import device_throughput as measure

    groups: Dict[str, list] = {}
    for op in graph.ops:
        if op.attrs.get("kernel") != "cuda":
            continue
        key = _op_table_key(graph, op)
        if key is not None:
            groups.setdefault(key, []).append(op)
    if not groups:
        return {}
    best = measure(graph, feed)
    if verbose:
        print(f"in-model baseline (every bucket on the kernel): {best:.1f} items/s",
              flush=True)
    decisions: Dict[str, str] = {}
    rows: Dict[str, dict] = {}
    for key in sorted(groups):
        for op in groups[key]:
            del op.attrs["kernel"]
        demoted = measure(graph, feed)
        rows[key] = {"with_cuda": best, "with_torch": demoted, "min_win": min_win}
        if best > demoted * min_win:
            for op in groups[key]:
                op.attrs["kernel"] = "cuda"
            decisions[key] = "cuda"
        else:
            decisions[key] = "torch"
            best = max(best, demoted)
        if verbose:
            print(f"  {key} ({len(groups[key])} ops): on the torch impl "
                  f"{demoted:.1f} items/s -> keep {decisions[key]}", flush=True)
    if persist:
        _store({k: {"winner": v, "in_model": rows[k]} for k, v in decisions.items()})
    return decisions
