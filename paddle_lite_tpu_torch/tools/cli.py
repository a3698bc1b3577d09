"""CLI — the ``opt`` tool analog (``lite/api/model_optimize_tool.cc``).

Port of ``paddle_lite_tpu/tools/cli.py`` (``:22-200``):

    python -m paddle_lite_tpu_torch.tools.cli compile --model mobilenet_v1 \\
        --batch 64 --image-size 224 --int8 --out model.pnb
    python -m paddle_lite_tpu_torch.tools.cli compile --model <fluid dir> \\
        --batch 64 --int8 --out model.pnb
    python -m paddle_lite_tpu_torch.tools.cli info --artifact model.pnb
    python -m paddle_lite_tpu_torch.tools.cli ops       # --print_all_ops analog
    python -m paddle_lite_tpu_torch.tools.cli passes
    python -m paddle_lite_tpu_torch.tools.cli profile --model mobilenet_v1
    python -m paddle_lite_tpu_torch.tools.cli tune --model ssd --batch 32 \\
        --image-size 300 --validate

``--model`` is a zoo name (a module of ``models/``) or a fluid model
directory (``__model__`` + params).  ``compile`` and ``profile`` calibrate
and run on ``--device`` (``cuda`` unless asked for ``cpu``); the artifact
``compile`` writes loads in either package (``formats/artifact.py``) and
runs through ``runtime.predictor.load_predictor``.  ``tune`` fills the
kernel table (``ops/kernels/tune_cache.py``: ``_tuning/kernels.json``, or
the directory ``PLT_TORCH_AUTOTUNE_DIR`` names) for a model's buckets on
the card, and with ``--validate`` A/Bs each of the kernel's buckets inside
the whole compiled model; it measures nothing on the CPU (it raises).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np


def _build_model(name: str, **kw):
    if os.path.isdir(name):  # fluid model dir (__model__ [+ params])
        from ..formats.fluid_convert import load_fluid_model

        return load_fluid_model(name, batch=kw.get("batch", 1))
    mod = importlib.import_module(f"paddle_lite_tpu_torch.models.{name}")
    return mod.build(**kw)


def _synthetic_feed(g, rng):
    return {g.inputs[0]: rng.normal(size=tuple(g.vars[g.inputs[0]].shape))
            .astype(np.float32)}


def cmd_compile(args) -> None:
    from .. import QuantConfig
    from ..core.types import CalibMethod
    from ..formats import artifact
    from .opt import optimize

    g = _build_model(args.model, batch=args.batch, image_size=args.image_size)
    quant = None
    calib = None
    if args.weight_only:
        quant = QuantConfig(weight_only=args.weight_only,
                            island_dtype=args.island_dtype)
    elif args.int8:
        quant = QuantConfig(method=CalibMethod(args.calib_method),
                            island_dtype=args.island_dtype)
        rng = np.random.default_rng(0)
        calib = [_synthetic_feed(g, rng) for _ in range(args.calib_batches)]
        print(f"calibrating with {args.calib_batches} synthetic batches "
              f"({args.calib_method}) on {args.device}; pass real data via the "
              f"library API for deployment-grade scales", file=sys.stderr)
    optimize(g, quant=quant, calib_batches=calib, device=args.device)
    artifact.save(g, args.out)
    n_int8 = sum(1 for op in g.ops if op.attrs.get("enable_int8"))
    print(json.dumps({"out": args.out, "ops": len(g.ops), "int8_ops": n_int8}))


def cmd_info(args) -> None:
    from ..formats import artifact

    g = artifact.load(args.artifact)
    by_type: dict = {}
    for op in g.ops:
        by_type[op.op_type] = by_type.get(op.op_type, 0) + 1
    print(json.dumps({
        "name": g.name,
        "inputs": {n: g.vars[n].shape for n in g.inputs},
        "outputs": g.outputs,
        "ops": len(g.ops),
        "int8_ops": sum(1 for op in g.ops if op.attrs.get("enable_int8")),
        "op_histogram": dict(sorted(by_type.items())),
        "weight_bytes": int(sum(w.nbytes for w in g.weights.values())),
    }, default=str))


def cmd_ops(args) -> None:
    from ..core.registry import OPS

    for name in OPS.names():
        impls = sorted(OPS.get(name).impls)
        print(f"{name:<32} kernels: {', '.join(impls) or '-'}")


def cmd_passes(args) -> None:
    from ..core.pass_manager import registered_passes

    for name in registered_passes():
        print(name)


def _repick(g) -> None:
    """Tag each table-driven op as the table now says (``select.
    choose_kernel``), dropping the ``"cuda"`` tag of a bucket measured
    ``"torch"``."""
    from ..ops.kernels import select, tune_cache
    from ..passes.kernel_pick import int8_activation

    for op in g.ops:
        if tune_cache._op_table_key(g, op) is None or not int8_activation(g, op):
            continue
        if select.choose_kernel(g, op) == "cuda":
            op.attrs["kernel"] = "cuda"
        else:
            op.attrs.pop("kernel", None)


def cmd_tune(args) -> None:
    """``cmd_tune`` of the reference (``cli.py:97-124`` there): measure
    every table-driven bucket of the model (optionally sweeping the GEMM's
    plans first), then, with ``--validate``, A/B each bucket left on the
    kernel inside the whole compiled model and demote those that do not
    win there.  Prints the decisions as JSON."""
    import functools

    from .. import QuantConfig
    from ..core.device import resolve_device
    from ..ops.kernels import tune_cache
    from .benchmark import device_throughput
    from .opt import optimize

    dev = resolve_device(args.device)
    g = _build_model(args.model, batch=args.batch, image_size=args.image_size)
    rng = np.random.default_rng(0)
    feed = {}
    for name in g.inputs:
        shape = tuple(g.vars[name].shape)
        dt = g.vars[name].precision.torch_dtype
        feed[name] = (rng.integers(0, 100, shape).astype(str(dt).split(".")[1])
                      if not dt.is_floating_point else rng.normal(size=shape).astype(np.float32))
    optimize(g, quant=QuantConfig(), calib_batches=[feed], device=dev)
    results = tune_cache.tune_graph(g, verbose=True, sweep_blocks=args.sweep_blocks,
                                    device=dev)
    if args.validate:
        # standalone winners are candidates only: re-pick with the fresh
        # table, then A/B each bucket left on the kernel in the whole model
        _repick(g)
        measure = functools.partial(device_throughput, device=dev, min_window=args.window)
        results.update(tune_cache.validate_in_model(g, feed, verbose=True, measure=measure))
    print(json.dumps(results))


def cmd_profile(args) -> None:
    """Per-layer int8-vs-fp32 precision report."""
    from .. import QuantConfig
    from ..core.pass_manager import PassManager
    from .opt import FUSION_PASSES, optimize
    from .profile import print_precision_report

    g_fp = _build_model(args.model, batch=args.batch, image_size=args.image_size)
    g_q = _build_model(args.model, batch=args.batch, image_size=args.image_size)
    PassManager(FUSION_PASSES).run(g_fp)
    feed = _synthetic_feed(g_q, np.random.default_rng(0))
    optimize(g_q, quant=QuantConfig(), calib_batches=[feed], device=args.device)
    print_precision_report(g_fp, g_q, feed, top=args.top, device=args.device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="paddle_lite_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compile", help="optimize (+quantize) a model to an artifact")
    c.add_argument("--model", required=True, help="zoo name or fluid model directory")
    c.add_argument("--batch", type=int, default=1)
    c.add_argument("--image-size", type=int, default=224)
    c.add_argument("--int8", action="store_true")
    c.add_argument("--weight-only", type=int, choices=[8, 16], default=None,
                   help="calibration-free weight-only storage quantization "
                        "(SaveModelNaive quantize-on-save analog)")
    c.add_argument("--island-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    c.add_argument("--calib-method", default="abs_max",
                   choices=["abs_max", "moving_average_abs_max", "percentile", "entropy"])
    c.add_argument("--calib-batches", type=int, default=4)
    c.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    c.add_argument("--out", required=True)
    c.set_defaults(fn=cmd_compile)

    i = sub.add_parser("info", help="inspect an artifact")
    i.add_argument("--artifact", required=True)
    i.set_defaults(fn=cmd_info)

    o = sub.add_parser("ops", help="list registered ops/kernels")
    o.set_defaults(fn=cmd_ops)

    ps = sub.add_parser("passes", help="list registered passes")
    ps.set_defaults(fn=cmd_passes)

    pr = sub.add_parser("profile", help="per-layer int8-vs-fp32 precision report")
    pr.add_argument("--model", required=True)
    pr.add_argument("--batch", type=int, default=1)
    pr.add_argument("--image-size", type=int, default=224)
    pr.add_argument("--top", type=int, default=20)
    pr.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pr.set_defaults(fn=cmd_profile)

    t = sub.add_parser("tune", help="measure the kernel table for a model on the card")
    t.add_argument("--model", required=True)
    t.add_argument("--batch", type=int, default=8)
    t.add_argument("--image-size", type=int, default=224)
    t.add_argument("--validate", action="store_true",
                   help="A/B each bucket left on the kernel inside the whole compiled "
                        "model and demote those that do not win there (before a table "
                        "ships)")
    t.add_argument("--sweep-blocks", action="store_true",
                   help="measure the GEMM's candidate plans for each bucket before "
                        "racing the kernel against the torch impl")
    t.add_argument("--window", type=float, default=0.4,
                   help="seconds each in-model reading spans (--validate)")
    t.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    t.set_defaults(fn=cmd_tune)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
