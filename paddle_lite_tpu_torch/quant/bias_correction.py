"""PTQ bias correction.

Copy of ``paddle_lite_tpu/quant/bias_correction.py`` (numpy only).

The systematic part of weight-quantization error is a per-output-channel
bias shift: E[(W - W_deq) · x] ≈ (W - W_deq) · E[x].  Correcting the conv/fc
bias by that expectation recovers a large share of PTQ accuracy loss at zero
runtime cost (the PaddleSlim/AdaRound-era "bias correction" technique; the
reference consumed scales from exactly this class of calibrator).

Applied inside ``tools/opt.optimize`` between weight quantization and
precision-cast insertion, using per-input-channel activation means recorded
by the calibration runner.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.ir import Graph

_WEIGHT_SLOT = {"conv2d": "Filter", "depthwise_conv2d": "Filter",
                "fc": "W", "mul": "Y"}
_DATA_SLOT = {"conv2d": "Input", "depthwise_conv2d": "Input",
              "fc": "Input", "mul": "X"}


def apply_bias_correction(
    graph: Graph,
    fp32_weights: Dict[str, np.ndarray],
    channel_means: Dict[str, np.ndarray],
) -> int:
    """Adjust biases of quantized ops; returns how many ops were corrected.

    ``fp32_weights``: pre-quantization weight snapshot (name → fp32 array).
    ``channel_means``: per-var E[x] along the channel (last) axis.
    """
    corrected = 0
    for op in graph.ops:
        if not op.attrs.get("enable_int8"):
            continue
        w_slot = _WEIGHT_SLOT.get(op.op_type)
        if w_slot is None or not op.maybe_input(w_slot):
            continue
        w_name = op.input(w_slot)
        if w_name not in fp32_weights:
            continue
        x_name = op.maybe_input(_DATA_SLOT[op.op_type])
        if x_name is None or x_name not in channel_means:
            continue
        w_fp = np.asarray(fp32_weights[w_name], np.float32)
        w_q = graph.weights[w_name]
        if w_q.dtype != np.int8:
            continue
        qinfo = graph.vars[w_name].quant
        scale = qinfo.scale_array()
        axis = qinfo.axis % w_fp.ndim
        shape = [1] * w_fp.ndim
        shape[axis] = -1
        w_deq = w_q.astype(np.float32) * scale.reshape(shape)
        err = w_fp - w_deq  # quantization residual

        ex = np.asarray(channel_means[x_name], np.float32)  # (C_in,)
        if op.op_type in ("conv2d", "fc", "mul"):
            # HWIO: sum over (h, w, i)·E[x_i]; (K,O): sum over K·E[x_k]
            red_axes = tuple(i for i in range(w_fp.ndim) if i != axis)
            in_axis = w_fp.ndim - 2  # I for HWIO, K for (K,O)
            bshape = [1] * w_fp.ndim
            bshape[in_axis] = -1
            delta = (err * ex.reshape(bshape)).sum(axis=red_axes)
        elif op.op_type == "depthwise_conv2d":
            # HW1O with O == C: each output channel sees only its own input
            delta = (err[:, :, 0, :] * ex.reshape(1, 1, -1)).sum(axis=(0, 1))
        else:
            continue

        if op.maybe_input("Bias"):
            b_name = op.input("Bias")
            graph.weights[b_name] = (
                graph.weights[b_name].astype(np.float32) + delta
            ).astype(np.float32)
        else:
            b_name = graph.unique_name(w_name + ".bcbias")
            graph.add_weight(b_name, delta.astype(np.float32))
            op.inputs["Bias"] = [b_name]
        corrected += 1
    graph.rebuild_links()
    return corrected
