"""`opt` — the optimize / quantize flow.

Port of ``paddle_lite_tpu/tools/opt.py`` (analog of the reference's ``opt``
CLI, ``lite/api/model_optimize_tool.cc``): fusions → (with ``quant``)
calibration of the fp32 graph on ``device`` by the config's method →
PTQ quantize → (with ``bias_correction``) the bias correction → (with
``fuse_dw_pw``) the dw+pw block fusion → (with ``conv1x1_dot``) the attr on
the int8 1x1 convs → precision-cast insertion → kernel pick.  With
``weight_only`` the graph's weights are stored narrow instead, with no
calibration and no fusion of blocks (``opt.py:67-74`` there).  The output is
the optimized :class:`Graph`; with ``QuantConfig(island_dtype="bfloat16")``
its ``meta["island_dtype"]`` is stamped after calibration (statistics are
collected in fp32), where the reference stamps it, and the executor then
runs the float regions in bf16 (``core/executor.py``).

An ``island_dtype`` other than ``"float32"`` and ``"bfloat16"`` raises
``NotImplementedError``; the reference treats any other value as float32
without a word (``core/executor.py:86`` there).
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable, Optional

import numpy as np

from ..core import trace
from ..core.device import DeviceLike, resolve_device
from ..core.ir import Graph
from ..core.pass_manager import PassManager
from ..core.types import CalibMethod
from ..ops.common import normalize_paddings
from ..quant.bias_correction import apply_bias_correction
from ..quant.calibrate import CalibrationResult, calibrate
from ..quant.quantize_pass import QuantConfig, ptq_quantize, weight_only_quantize

FUSION_PASSES = [
    "identity_elimination",
    "quant_dequant_fuse",  # no-op unless the graph carries QAT fake ops
    "deconv_pack",
    "conv_bn_fuse",
    "conv_elementwise_fuse",
    "conv_activation_fuse",
    "fc_fuse",
    "fc_activation_fuse",
    "parallel_fc_fuse",
]

FINALIZE_PASSES = [
    "precision_cast",
    "kernel_pick",
]


def _unported(quant: QuantConfig) -> Optional[str]:
    if quant.island_dtype not in ("float32", "bfloat16"):
        return f"island_dtype={quant.island_dtype!r}"
    return None


def conv1x1_dot_eligible(graph: Graph, op) -> bool:
    """An int8 conv2d with a 1x1 filter and no padding: the reference's gate
    (``opt.py:116-123`` there) with the paddings check it lacks, so a
    padded 1x1 conv keeps the conv form."""
    return (op.op_type == "conv2d" and bool(op.attrs.get("enable_int8"))
            and graph.vars[op.input("Filter")].shape[:2] == (1, 1)
            and normalize_paddings(op.attrs.get("paddings", (0, 0))) == ((0, 0), (0, 0)))


@trace.setup_span("setup.optimize")  # its self time: the calibration is its own
def optimize(
    graph: Graph,
    *,
    quant: Optional[QuantConfig] = None,
    calib_batches: Optional[Iterable[Dict[str, np.ndarray]]] = None,
    calib_result: Optional[CalibrationResult] = None,
    fuse_dw_pw: bool = False,
    verbose: bool = False,
    device: DeviceLike = None,
) -> Graph:
    """Run the full optimization pipeline in-place and return the graph.

    ``device`` is where calibration runs the fp32 graph: ``"cuda"`` unless
    the caller asks for ``"cpu"``; with no card, the default raises.
    """
    dev = resolve_device(device)
    if quant is not None:
        what = _unported(quant)
        if what:
            raise NotImplementedError(f"QuantConfig {what} is not ported yet")
    PassManager(FUSION_PASSES).run(graph, verbose=verbose)
    if quant is not None and quant.weight_only:
        # narrow storage, no calibration and no block fusion
        weight_only_quantize(graph, bits=quant.weight_only)
    elif quant is not None:
        if quant.method is CalibMethod.ENTROPY:
            warnings.warn(
                "CalibMethod.ENTROPY (KL) measurably degrades accuracy on "
                "the measured zoo models (docs/ACCURACY.md); abs_max is the "
                "validated default", stacklevel=3)  # past setup_span's wrapper
        if calib_result is None:
            if calib_batches is None:
                raise ValueError("PTQ needs calib_batches or calib_result")
            calib_result = calibrate(
                graph, calib_batches, method=quant.method, device=dev,
                bins=quant.bins, observer_kwargs=quant.observer_kwargs,
                collect_channel_means=quant.bias_correction)
        fp32_snapshot = (
            {k: np.array(v, copy=True) for k, v in graph.weights.items()
             if v.dtype == np.float32}
            if quant.bias_correction else None)
        ptq_quantize(graph, calib_result, quant)
        if quant.bias_correction:
            apply_bias_correction(graph, fp32_snapshot, calib_result.channel_means)
        if fuse_dw_pw or quant.fuse_dw_pw:
            # dw + pw int8 blocks as one kernel (ops/fused.py)
            PassManager(["dw_pw_fuse"]).run(graph, verbose=verbose)
        if quant.conv1x1_dot:
            for op in graph.ops:
                if conv1x1_dot_eligible(graph, op):
                    op.attrs["conv1x1_dot"] = True
    PassManager(FINALIZE_PASSES).run(graph, verbose=verbose)
    if quant is not None and quant.island_dtype != "float32":
        # stamped after calibration, so statistics are collected in fp32
        graph.meta["island_dtype"] = quant.island_dtype
    return graph
