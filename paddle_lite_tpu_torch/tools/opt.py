"""`opt` — the optimize / quantize flow.

Port of ``paddle_lite_tpu/tools/opt.py`` (analog of the reference's ``opt``
CLI, ``lite/api/model_optimize_tool.cc``): fusions → (with ``quant``)
calibration of the fp32 graph on ``device`` → PTQ quantize → (with
``fuse_dw_pw``) the dw+pw block fusion → precision-cast insertion → kernel
pick.  The output is the optimized :class:`Graph`; with
``QuantConfig(island_dtype="bfloat16")`` its ``meta["island_dtype"]`` is
stamped after calibration (statistics are collected in fp32), where the
reference stamps it (``opt.py:125-127`` there), and the executor then runs
the float regions in bf16 (``core/executor.py``).

Options of :class:`QuantConfig` that are off by default and not on the
ported path raise ``NotImplementedError`` rather than being ignored.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from ..core.device import DeviceLike, resolve_device
from ..core.ir import Graph
from ..core.pass_manager import PassManager
from ..core.types import CalibMethod
from ..quant.calibrate import CalibrationResult, calibrate
from ..quant.quantize_pass import QuantConfig, ptq_quantize

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
    if quant.weight_only:
        return "weight_only"
    if quant.conv1x1_dot:
        return "conv1x1_dot"
    if quant.bias_correction:
        return "bias_correction"
    if quant.island_dtype not in ("float32", "bfloat16"):
        return f"island_dtype={quant.island_dtype!r}"
    if quant.method is not CalibMethod.ABS_MAX:
        return f"method={quant.method}"
    return None


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
    if quant is not None:
        if calib_result is None:
            if calib_batches is None:
                raise ValueError("PTQ needs calib_batches or calib_result")
            calib_result = calibrate(
                graph, calib_batches, method=quant.method, device=dev,
                observer_kwargs=quant.observer_kwargs)
        ptq_quantize(graph, calib_result, quant)
        if fuse_dw_pw or quant.fuse_dw_pw:
            # dw + pw int8 blocks as one kernel (ops/fused.py)
            PassManager(["dw_pw_fuse"]).run(graph, verbose=verbose)
    PassManager(FINALIZE_PASSES).run(graph, verbose=verbose)
    if quant is not None and quant.island_dtype != "float32":
        # stamped after calibration, so statistics are collected in fp32
        graph.meta["island_dtype"] = quant.island_dtype
    return graph
