"""A seeded :class:`~.arena.OpTestCase` for every registered op name.

``cases(card=False)`` gives the CPU size (a few elements an axis, what the
cross-package tests run against the JAX package); ``cases(card=True)``
the size the card runs (``chip_smoke.py`` phase 14a: batch 8, 32 × 32
maps, 64 channels).  Inputs come from numpy's generator seeded by the op
name, so both sizes and both devices see the same values for the same
size.

Tolerance classes (the cross-package tests' rule, ``arena.compare``):
data movement, integer and boolean results, and float arithmetic of one
IEEE operation an element are exact; transcendental functions, reductions,
matmuls and convolutions, and accumulation in another order hold to rtol
1e-5 / atol 1e-6 against the reference.  The card against the CPU: float
results of an exact case still exact, others within the case's
``card_rtol`` / ``card_atol`` (1e-5 / 1e-5; 1e-4 where a long sum runs in
another order on the card).
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict

import numpy as np

from ..core.builder import GraphBuilder
from ..core.ir import Graph
from ..core.types import Precision
from ..ops.detection import anchors as make_anchors
from .arena import OpTestCase

F32 = np.float32


class _Gen:
    """Seeded input makers for one case."""

    def __init__(self, name: str):
        self.rng = np.random.default_rng(zlib.crc32(name.encode()))

    def n(self, *shape, scale=1.0):
        return (self.rng.normal(size=shape) * scale).astype(F32)

    def u(self, *shape, lo=0.0, hi=1.0):
        return self.rng.uniform(lo, hi, size=shape).astype(F32)

    def i(self, *shape, lo=0, hi=10, dtype=np.int32):
        return self.rng.integers(lo, hi, size=shape).astype(dtype)

    def b(self, *shape, p=0.5):
        return self.rng.random(shape) < p

    def i8(self, *shape):
        return self.rng.integers(-127, 128, size=shape).astype(np.int8)

    def boxes(self, *lead, size=1.0):
        xy = self.rng.uniform(0, size * 0.7, size=lead + (2,))
        wh = self.rng.uniform(size * 0.05, size * 0.3, size=lead + (2,))
        return np.concatenate([xy, xy + wh], axis=-1).astype(F32)


def _loop_block(limit: float) -> Graph:
    """A ``while`` body: (cond, x) -> (x + 1 < limit, x + 1)."""
    bb = GraphBuilder("loop_body")
    bb.input("cond_in", (1,), precision=Precision.BOOL)
    x = bb.input("x_in", (1,))
    bb.weight("one", np.ones((1,), F32))
    bb.weight("limit", np.full((1,), limit, F32))
    nx = bb.eltwise(x, "one", "add")
    nc = bb.op("less_than", {"X": [nx], "Y": ["limit"]}, shape_args=[nx, "limit"],
               out_precisions=[Precision.BOOL])[0]
    bb.mark_output(nc, nx)
    return bb.build()


def _affine_block(shape) -> Graph:
    """A block of one state var: y = tanh(x · 0.5 + w)."""
    bb = GraphBuilder("affine_body")
    x = bb.input("x_in", shape)
    bb.weight("w", np.linspace(-1, 1, int(np.prod(shape)), dtype=F32).reshape(shape))
    y = bb.op("scale", {"X": [x]}, attrs={"scale": 0.5, "bias": 0.0})[0]
    y = bb.eltwise(y, "w", "add")
    y = bb.act(y, "tanh")
    bb.mark_output(y)
    return bb.build()


def cases(card: bool = False) -> Dict[str, OpTestCase]:
    """name -> case, every registered op name once."""
    B, S, C = (8, 32, 64) if card else (2, 6, 3)
    T, H, V = (16, 64, 512) if card else (5, 4, 12)
    out: Dict[str, OpTestCase] = {}

    def case(name, make: Callable[[_Gen], OpTestCase]):
        out[name] = make(_Gen(name))

    def unary(name, x=None, exact=False, **attrs):
        case(name, lambda g: OpTestCase(name, {"X": [g.n(B, S, C) if x is None else x(g)]},
                                        attrs, exact=exact))

    # ---- activations ------------------------------------------------------------
    for name in ("relu", "relu6", "abs", "square", "floor"):
        unary(name, lambda g: g.n(B, S, C, scale=4.0), exact=True)
    unary("leaky_relu", exact=True, alpha=0.1)
    unary("relu_clipped", lambda g: g.n(B, S, C, scale=4.0), exact=True, Relu_clipped_coef=3.0)
    for name in ("sigmoid", "tanh", "swish", "hard_swish", "hard_sigmoid", "gelu",
                 "exp", "mish", "elu", "softplus", "softsign", "silu"):
        unary(name)
    for name in ("sqrt", "rsqrt", "log", "reciprocal"):
        unary(name, lambda g: g.u(B, S, C, lo=0.1, hi=4.0))

    # ---- elementwise / compare / logical ---------------------------------------------
    for name in ("elementwise_add", "elementwise_sub", "elementwise_mul",
                 "elementwise_div", "elementwise_max", "elementwise_min"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.n(B, S, C)], "Y": [g.n(C) + 3.0]}, {"axis": -1}))
    case("elementwise_pow", lambda g: OpTestCase(
        "elementwise_pow", {"X": [g.u(B, S, C, lo=0.5, hi=2.0)], "Y": [g.u(C, lo=-2, hi=2)]},
        {"axis": -1}, exact=False))
    for name in ("elementwise_mod", "elementwise_floordiv"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.i(B, S, C, lo=-50, hi=50)], "Y": [g.i(C, lo=1, hi=7)]},
            {"axis": -1}, outs=(("Out", "INT32"),)))
    for name in ("less_than", "less_equal", "greater_than", "greater_equal",
                 "equal", "not_equal"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.i(B, S, C, hi=4).astype(F32)], "Y": [g.i(B, S, C, hi=4).astype(F32)]},
            outs=(("Out", "BOOL"),)))
    for name in ("logical_and", "logical_or", "logical_xor"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.b(B, S, C)], "Y": [g.b(B, S, C)]}, outs=(("Out", "BOOL"),)))
    case("logical_not", lambda g: OpTestCase(
        "logical_not", {"X": [g.b(B, S, C)]}, outs=(("Out", "BOOL"),)))
    case("scale", lambda g: OpTestCase("scale", {"X": [g.n(B, S, C)]},
                                       {"scale": 1.5, "bias": 0.25}, exact=False))
    case("clip", lambda g: OpTestCase("clip", {"X": [g.n(B, S, C)]}, {"min": -0.5, "max": 0.7}))
    case("cast", lambda g: OpTestCase("cast", {"X": [g.n(B, S, C, scale=9.0)]},
                                      {"out_dtype": "int32"}, outs=(("Out", "INT32"),)))

    # ---- nn -----------------------------------------------------------------------------
    case("conv2d", lambda g: OpTestCase(
        "conv2d", {"Input": [g.n(B, S, S, C)], "Filter": [g.n(3, 3, C, 2 * C, scale=0.3)],
                   "Bias": [g.n(2 * C)]},
        {"strides": [2, 2], "paddings": [1, 1]}, outs=(("Output", "FP32"),), exact=False,
        card_rtol=1e-4))
    case("depthwise_conv2d", lambda g: OpTestCase(
        "depthwise_conv2d", {"Input": [g.n(B, S, S, C)], "Filter": [g.n(3, 3, 1, C)]},
        {"strides": [1, 1], "paddings": [1, 1]}, outs=(("Output", "FP32"),), exact=False))
    case("conv2d_transpose", lambda g: OpTestCase(
        "conv2d_transpose", {"Input": [g.n(B, S, S, C)], "Filter": [g.n(2, 2, C, C, scale=0.5)]},
        {"strides": [2, 2]}, outs=(("Output", "FP32"),), exact=False))
    case("fc", lambda g: OpTestCase(
        "fc", {"Input": [g.n(B, 4 * C)], "W": [g.n(4 * C, C, scale=0.2)], "Bias": [g.n(C)]},
        {}, exact=False, card_rtol=1e-4))
    case("mul", lambda g: OpTestCase(
        "mul", {"X": [g.n(B, 4 * C)], "Y": [g.n(4 * C, C, scale=0.2)]}, {}, exact=False,
        card_rtol=1e-4))
    for name in ("matmul", "matmul_v2"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.n(B, S, C)], "Y": [g.n(B, S, C)]}, {"transpose_Y": True},
            exact=False, card_rtol=1e-4))
    case("bmm", lambda g: OpTestCase(
        "bmm", {"X": [g.n(B, S, C)], "Y": [g.n(B, C, S)]}, exact=False, card_rtol=1e-4))
    case("batch_norm", lambda g: OpTestCase(
        "batch_norm", {"X": [g.n(B, S, S, C)], "Scale": [g.n(C)], "Bias": [g.n(C)],
                       "Mean": [g.n(C)], "Variance": [g.u(C, lo=0.5, hi=2.0)]},
        {"epsilon": 1e-5}, outs=(("Y", "FP32"),), exact=False))
    case("layer_norm", lambda g: OpTestCase(
        "layer_norm", {"X": [g.n(B, S, C * 4)], "Scale": [g.n(C * 4)], "Bias": [g.n(C * 4)]},
        {"begin_norm_axis": 2}, outs=(("Y", "FP32"),), exact=False))
    case("pool2d", lambda g: OpTestCase(
        "pool2d", {"X": [g.n(B, S, S, C)]},
        {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
        exact=False))
    case("softmax", lambda g: OpTestCase("softmax", {"X": [g.n(B, S, C)]}, {"axis": -1},
                                         exact=False))
    case("dropout", lambda g: OpTestCase(
        "dropout", {"X": [g.n(B, S, C)]},
        {"dropout_prob": 0.3, "dropout_implementation": "downgrade_in_infer"}, exact=False))
    case("prelu", lambda g: OpTestCase(
        "prelu", {"X": [g.n(B, S, S, C)], "Alpha": [g.n(C)]}, {"mode": "channel"}))
    case("quantize", lambda g: OpTestCase(
        "quantize", {"X": [g.n(B, S, C)]}, outs=(("Out", "INT8"),),
        scales={"out_out0": 0.02}))
    case("dequantize", lambda g: OpTestCase(
        "dequantize", {"X": [g.i8(B, S, C)]}, scales={"x0": 0.05}))
    case("calib", lambda g: OpTestCase(
        "calib", {"X": [g.n(B, S, C)]}, outs=(("Out", "INT8"),), scales={"out_out0": 0.02}))
    case("fused_dw_pw", lambda g: OpTestCase(
        "fused_dw_pw", {"Input": [g.i8(B, S, S, C)], "DwFilter": [g.i8(3, 3, 1, C)],
                        "PwFilter": [g.i8(1, 1, C, 2 * C)]},
        {"dw_out_scale": 0.5, "out_scale": 0.9, "dw_act": "relu", "pw_act": "relu"},
        outs=(("Output", "INT8"),),
        scales={"input0": 0.05, "dwfilter0": 0.01, "pwfilter0": 0.01}))

    # ---- sequence ----------------------------------------------------------------------
    case("gru", lambda g: OpTestCase(
        "gru", {"Input": [g.n(B, T, 3 * H)], "Weight": [g.n(H, 3 * H, scale=0.3)],
                "Bias": [g.n(3 * H, scale=0.1)]}, outs=(("Hidden", "FP32"),), exact=False))
    case("bidirectional_gru", lambda g: OpTestCase(
        "bidirectional_gru", {"Input": [g.n(B, T, 3 * H)], "InputRev": [g.n(B, T, 3 * H)],
                              "WeightFw": [g.n(H, 3 * H, scale=0.3)],
                              "WeightBw": [g.n(H, 3 * H, scale=0.3)]},
        outs=(("Hidden", "FP32"),), exact=False))
    case("lstm", lambda g: OpTestCase(
        "lstm", {"Input": [g.n(B, T, 4 * H)], "Weight": [g.n(H, 4 * H, scale=0.3)],
                 "Bias": [g.n(4 * H, scale=0.1)]},
        outs=(("Hidden", "FP32"), ("Cell", "FP32")), exact=False))
    case("gru_unit", lambda g: OpTestCase(
        "gru_unit", {"Input": [g.n(B, 3 * H)], "HiddenPrev": [g.n(B, H)],
                     "Weight": [g.n(H, 3 * H, scale=0.3)], "Bias": [g.n(3 * H, scale=0.1)]},
        outs=(("Hidden", "FP32"), ("ResetHiddenPrev", "FP32"), ("Gate", "FP32")),
        exact=False))
    case("ctc_greedy_decode", lambda g: OpTestCase(
        "ctc_greedy_decode", {"X": [g.i(B, T, C + 2, hi=8).astype(F32)]},
        outs=(("Out", "INT32"), ("Length", "INT32"))))
    case("im2sequence", lambda g: OpTestCase(
        "im2sequence", {"X": [g.n(B, S, S, C)]}, {"kernels": [2, 3], "strides": [2, 1]}))
    case("sequence_softmax", lambda g: OpTestCase("sequence_softmax", {"X": [g.n(B, T, C)]},
                                                  exact=False))
    case("sequence_reverse", lambda g: OpTestCase("sequence_reverse", {"X": [g.n(B, T, C)]},
                                                  outs=(("Y", "FP32"),)))
    case("sequence_pool", lambda g: OpTestCase("sequence_pool", {"X": [g.n(B, T, C)]},
                                               {"pooltype": "AVERAGE"}, exact=False))
    case("sequence_expand", lambda g: OpTestCase(
        "sequence_expand", {"X": [g.n(B, C)], "Y": [g.n(B, T, C)]}))
    case("sequence_concat", lambda g: OpTestCase(
        "sequence_concat", {"X": [g.n(B, T, C), g.n(B, 3, C)]}))
    case("sequence_mask", lambda g: OpTestCase(
        "sequence_mask", {"X": [g.i(B, 3, hi=T + 1)]}, {"maxlen": T}, outs=(("Y", "FP32"),)))
    case("beam_search", lambda g: OpTestCase(
        "beam_search", {"pre_ids": [g.i(B, 4, hi=V)], "pre_scores": [g.n(B, 4)],
                        "scores": [g.u(B, 4, V, lo=0.0, hi=1.0)]},
        {"end_id": 1}, outs=(("selected_ids", "INT32"), ("selected_scores", "FP32"),
                             ("parent_idx", "INT32")), exact=False))

    # ---- manipulation ---------------------------------------------------------------------
    x4 = lambda g: g.n(B, S, S, C)  # noqa: E731
    case("reshape", lambda g: OpTestCase("reshape", {"X": [x4(g)]}, {"shape": [B, -1, C]}))
    case("reshape2", lambda g: OpTestCase("reshape2", {"X": [x4(g)]}, {"shape": [0, S * S, C]}))
    for name in ("transpose", "transpose2"):
        case(name, lambda g, name=name: OpTestCase(name, {"X": [x4(g)]}, {"axis": [0, 3, 1, 2]}))
    case("concat", lambda g: OpTestCase("concat", {"X": [x4(g), x4(g)]}, {"axis": 3}))
    case("split", lambda g: OpTestCase("split", {"X": [x4(g)]}, {"axis": 1, "sections": [2, S - 2]},
                                       outs=(("Out", "FP32"),) * 2))
    case("slice", lambda g: OpTestCase("slice", {"X": [x4(g)]},
                                       {"axes": [1, 2], "starts": [1, -3], "ends": [4, 10000]}))
    for name in ("lookup_table", "lookup_table_v2"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"W": [g.n(V, C)], "Ids": [g.i(B, T, 1, lo=-V - 2, hi=V + 2)]}))
    for name in ("nearest_interp", "nearest_interp_v2"):
        case(name, lambda g, name=name: OpTestCase(name, {"X": [x4(g)]}, {"scale": 2.0}))
    for name in ("bilinear_interp", "bilinear_interp_v2"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [x4(g)]}, {"out_h": S + 3, "out_w": 2 * S - 1, "align_corners": False},
            exact=False))
    case("pixel_shuffle", lambda g: OpTestCase("pixel_shuffle", {"X": [g.n(B, S, S, 4 * C)]},
                                               {"upscale_factor": 2}))
    for name in ("flatten", "flatten2"):
        case(name, lambda g, name=name: OpTestCase(name, {"X": [x4(g)]}, {"axis": 2}))
    case("flatten_contiguous_range", lambda g: OpTestCase(
        "flatten_contiguous_range", {"X": [x4(g)]}, {"start_axis": 1, "stop_axis": 2}))
    for name in ("squeeze", "squeeze2"):
        case(name, lambda g, name=name: OpTestCase(name, {"X": [g.n(B, 1, S, 1)]}, {"axes": [-1]}))
    for name in ("unsqueeze", "unsqueeze2"):
        case(name, lambda g, name=name: OpTestCase(name, {"X": [g.n(B, S, C)]}, {"axes": [0, -1]}))
    case("stack", lambda g: OpTestCase("stack", {"X": [g.n(B, S, C), g.n(B, S, C)]},
                                       {"axis": -2}, outs=(("Y", "FP32"),)))
    case("assign", lambda g: OpTestCase("assign", {"X": [x4(g)]}))
    for name in ("reduce_mean", "reduce_sum", "reduce_prod"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.u(B, S, C, lo=0.8, hi=1.2)]}, {"dim": [1], "keep_dim": False},
            exact=False))
    for name in ("reduce_max", "reduce_min"):
        case(name, lambda g, name=name: OpTestCase(name, {"X": [x4(g)]},
                                                   {"dim": [1, 2], "keep_dim": True}))
    for name in ("reduce_all", "reduce_any"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.b(B, S, C, p=0.8)]}, {"dim": [-1], "keep_dim": False},
            outs=(("Out", "BOOL"),)))
    case("arg_max", lambda g: OpTestCase("arg_max", {"X": [g.i(B, S, C, hi=3).astype(F32)]},
                                         {"axis": 1}, outs=(("Out", "INT64"),)))
    case("fill_constant", lambda g: OpTestCase(
        "fill_constant", {}, {"shape": [B, C], "value": 1.5, "dtype": "float32"}))
    case("shape", lambda g: OpTestCase("shape", {"Input": [x4(g)]}, outs=(("Out", "INT32"),)))
    case("expand", lambda g: OpTestCase("expand", {"X": [g.n(B, 1, C)]},
                                        {"expand_times": [1, S, 2]}))
    case("shuffle_channel", lambda g: OpTestCase("shuffle_channel", {"X": [g.n(B, S, S, 4 * C)]},
                                                 {"group": 2}))
    case("pad2d", lambda g: OpTestCase("pad2d", {"X": [x4(g)]},
                                       {"paddings": [1, 2, 2, 1], "mode": "reflect"}))
    case("space_to_depth", lambda g: OpTestCase("space_to_depth", {"X": [x4(g)]},
                                                {"blocks": [2, 2]}))
    case("top_k", lambda g: OpTestCase(
        "top_k", {"X": [g.i(B, S, 2 * C, hi=5).astype(F32)]}, {"k": 3},
        outs=(("Out", "FP32"), ("Indices", "INT64"))))
    case("gather", lambda g: OpTestCase(
        "gather", {"X": [g.n(V, C)], "Index": [g.i(2 * B, lo=-V - 2, hi=V + 2)]}))
    case("norm", lambda g: OpTestCase("norm", {"X": [x4(g)]}, {"axis": -1, "epsilon": 1e-10},
                                      exact=False))

    # ---- extra -------------------------------------------------------------------------------
    for name in ("erf", "sin", "cos"):
        unary(name)
    case("sign", lambda g: OpTestCase("sign", {"X": [g.i(B, S, C, lo=-2, hi=3).astype(F32)]}))
    for name in ("ceil", "round"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [(g.i(B, S, C, lo=-9, hi=10) * 0.5).astype(F32)]}))
    for name in ("add_n", "sum"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.n(B, S, C), g.n(B, S, C), g.n(B, S, C)]}, exact=False))
    case("cumsum", lambda g: OpTestCase("cumsum", {"X": [g.n(B, S, C)]}, {"axis": 1},
                                        exact=False))
    case("expand_as", lambda g: OpTestCase("expand_as", {"X": [g.n(B, 1, C)], "Y": [g.n(B, S, C)]}))
    case("group_norm", lambda g: OpTestCase(
        "group_norm", {"X": [g.n(B, S, S, 2 * C)], "Scale": [g.n(2 * C)], "Bias": [g.n(2 * C)]},
        {"groups": 2, "epsilon": 1e-5}, outs=(("Y", "FP32"),), exact=False))
    case("instance_norm", lambda g: OpTestCase(
        "instance_norm", {"X": [x4(g)], "Scale": [g.n(C)], "Bias": [g.n(C)]},
        {"epsilon": 1e-5}, outs=(("Y", "FP32"),), exact=False))
    case("meshgrid", lambda g: OpTestCase("meshgrid", {"X": [g.n(B), g.n(S), g.n(C)]},
                                          outs=(("Out", "FP32"),) * 3))
    for name in ("one_hot", "one_hot_v2"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.i(B, S, lo=-2, hi=C + 3)]}, {"depth": C + 1}))
    case("tile", lambda g: OpTestCase("tile", {"X": [g.n(B, S, C)]}, {"repeat_times": [2, 3]}))
    case("unstack", lambda g: OpTestCase("unstack", {"X": [g.n(B, 3, C)]}, {"axis": 1},
                                         outs=(("Y", "FP32"),) * 3))
    case("where", lambda g: OpTestCase(
        "where", {"Condition": [g.b(B, S, C)], "X": [g.n(B, S, C)], "Y": [g.n(B, S, C)]}))
    fq_x = lambda g: g.n(B, S, S, C, scale=2.0)  # noqa: E731
    case("fake_quantize_abs_max", lambda g: OpTestCase(
        "fake_quantize_abs_max", {"X": [fq_x(g)]}, {"bit_length": 8}, exact=False))
    case("fake_quantize_range_abs_max", lambda g: OpTestCase(
        "fake_quantize_range_abs_max", {"X": [fq_x(g)], "InScale": [np.array([1.7], F32)]},
        {"bit_length": 8}, exact=False))
    case("fake_quantize_moving_average_abs_max", lambda g: OpTestCase(
        "fake_quantize_moving_average_abs_max", {"X": [fq_x(g)]},
        {"scale": 2.5, "bit_length": 8}, exact=False))
    case("fake_quantize_dequantize_moving_average_abs_max", lambda g: OpTestCase(
        "fake_quantize_dequantize_moving_average_abs_max",
        {"X": [fq_x(g)], "InScale": [np.array([-0.9], F32)]}, {"bit_length": 8}, exact=False))
    case("fake_quantize_dequantize_abs_max", lambda g: OpTestCase(
        "fake_quantize_dequantize_abs_max", {"X": [fq_x(g)]}, {"bit_length": 4}, exact=False))
    case("fake_dequantize_max_abs", lambda g: OpTestCase(
        "fake_dequantize_max_abs", {"X": [fq_x(g)], "Scales": [np.array([3.0], F32)]},
        {"max_range": 127.0}))
    case("fake_channel_wise_dequantize_max_abs", lambda g: OpTestCase(
        "fake_channel_wise_dequantize_max_abs", {"X": [fq_x(g)], "Scales": [g.u(C, lo=0.5)]},
        {"quant_bits": [8]}))

    # ---- detection --------------------------------------------------------------------------
    case("prior_box", lambda g: OpTestCase(
        "prior_box", {"Input": [g.n(1, S // 2, S // 2, C)], "Image": [g.n(1, 4 * S, 4 * S, 3)]},
        {"min_sizes": [8.0, 20.0], "max_sizes": [16.0, 32.0], "aspect_ratios": [2.0],
         "flip": True, "clip": True, "variances": [0.1, 0.1, 0.2, 0.2]},
        outs=(("Boxes", "FP32"), ("Variances", "FP32"))))
    case("density_prior_box", lambda g: OpTestCase(
        "density_prior_box", {"Input": [g.n(1, S // 2, S // 2, C)],
                              "Image": [g.n(1, 4 * S, 4 * S, 3)]},
        {"fixed_sizes": [8.0, 16.0], "fixed_ratios": [1.0], "densities": [2, 1],
         "variances": [0.1, 0.1, 0.2, 0.2], "clip": True, "offset": 0.5},
        outs=(("Boxes", "FP32"), ("Variances", "FP32"))))
    case("box_coder", lambda g: OpTestCase(
        "box_coder", {"PriorBox": [g.boxes(4 * S)], "PriorBoxVar": [g.u(4 * S, 4, lo=0.1, hi=0.3)],
                      "TargetBox": [g.n(B, 4 * S, 4, scale=0.5)]},
        {"code_type": "decode_center_size", "box_normalized": True},
        outs=(("OutputBox", "FP32"),), exact=False))
    case("yolo_box", lambda g: OpTestCase(
        "yolo_box", {"X": [g.n(1, S // 2, S // 2, 2 * (5 + 3))],
                     "ImgSize": [np.array([[96, 128]], np.int32)]},
        {"anchors": [10, 13, 16, 30], "class_num": 3, "conf_thresh": 0.4,
         "downsample_ratio": 32, "clip_bbox": True},
        outs=(("Boxes", "FP32"), ("Scores", "FP32")), exact=False))
    for name in ("multiclass_nms", "multiclass_nms2"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"BBoxes": [g.boxes(B, 4 * S)], "Scores": [g.u(B, 4 * S, 4)]},
            {"nms_threshold": 0.4, "score_threshold": 0.05, "nms_top_k": 3 * S,
             "keep_top_k": 2 * S, "background_label": 0}, exact=False))
    case("anchor_generator", lambda g: OpTestCase(
        "anchor_generator", {"Input": [g.n(1, S // 2, S, C)]},
        {"anchor_sizes": [32.0, 64.0, 128.0], "aspect_ratios": [0.5, 1.0, 2.0],
         "stride": [16.0, 16.0], "variances": [1.0, 1.0, 1.0, 1.0], "offset": 0.5},
        outs=(("Anchors", "FP32"), ("Variances", "FP32"))))

    def _rpn(g):
        fh, fw, a = S // 2, S, 3
        anchors, variances = make_anchors(
            {"anchor_sizes": [16.0, 32.0, 64.0], "aspect_ratios": [1.0],
             "variances": [1.0, 1.0, 1.0, 1.0]}, fh, fw)
        return OpTestCase(
            "generate_proposals",
            {"Scores": [g.u(1, fh, fw, a)], "BboxDeltas": [g.n(1, fh, fw, 4 * a, scale=0.2)],
             "ImShape": [np.array([[16.0 * fh, 16.0 * fw]], F32)],
             "Anchors": [anchors], "Variances": [variances]},
            {"pre_nms_topN": fh * fw * a // 2, "post_nms_topN": 2 * S, "nms_thresh": 0.7,
             "min_size": 0.0},
            outs=(("RpnRois", "FP32"), ("RpnRoiProbs", "FP32")), exact=False,
            weight_slots=("Anchors", "Variances"))

    case("generate_proposals", _rpn)
    case("roi_align", lambda g: OpTestCase(
        "roi_align", {"X": [g.n(1, S, S, C)], "ROIs": [g.boxes(2 * S, size=8.0 * S)]},
        {"pooled_height": 3, "pooled_width": 3, "spatial_scale": 0.125, "sampling_ratio": 0},
        exact=False))
    case("box_clip", lambda g: OpTestCase(
        "box_clip", {"Input": [g.boxes(B, 4 * S, size=60.0) - 5.0],
                     "ImInfo": [np.tile(np.array([[40.0, 48.0, 1.0]], F32), (B, 1))]},
        outs=(("Output", "FP32"),)))
    case("matrix_nms", lambda g: OpTestCase(
        "matrix_nms", {"BBoxes": [g.boxes(B, 2 * S)], "Scores": [g.u(B, 3, 2 * S)]},
        {"score_threshold": 0.1, "post_threshold": 0.05, "keep_top_k": 3 * S,
         "use_gaussian": False}, exact=False))

    # ---- longtail --------------------------------------------------------------------------------
    case("pow", lambda g: OpTestCase("pow", {"X": [g.u(B, S, C, lo=0.1, hi=3.0)]},
                                     {"factor": 2.5}, exact=False))
    case("increment", lambda g: OpTestCase("increment", {"X": [g.n(B, C)]}, {"step": 2.0}))
    case("thresholded_relu", lambda g: OpTestCase("thresholded_relu", {"X": [g.n(B, S, C)]},
                                                  {"threshold": 0.3}))
    case("brelu", lambda g: OpTestCase("brelu", {"X": [g.n(B, S, C, scale=10.0)]},
                                       {"t_min": 1.0, "t_max": 6.0}))
    case("hard_shrink", lambda g: OpTestCase("hard_shrink", {"X": [g.n(B, S, C)]},
                                             {"threshold": 0.4}))
    case("softshrink", lambda g: OpTestCase("softshrink", {"X": [g.n(B, S, C)]},
                                            {"lambda": 0.4}))
    unary("tanh_shrink")
    case("log_softmax", lambda g: OpTestCase("log_softmax", {"X": [g.n(B, S, C)]},
                                             {"axis": 1}, exact=False))
    case("fill_any_like", lambda g: OpTestCase("fill_any_like", {"X": [g.n(B, S)]},
                                               {"value": 2.5}))
    case("fill_zeros_like", lambda g: OpTestCase("fill_zeros_like", {"X": [g.n(B, S)]}))
    case("clip_by_norm", lambda g: OpTestCase("clip_by_norm", {"X": [g.n(B, S, C)]},
                                              {"max_norm": 1.5}, exact=False))
    case("lod_reset", lambda g: OpTestCase("lod_reset", {"X": [g.n(B, S)]}))
    for name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.i(B, S, lo=-99, hi=99)], "Y": [g.i(B, S, lo=-99, hi=99)]},
            outs=(("Out", "INT32"),)))
    case("bitwise_not", lambda g: OpTestCase("bitwise_not", {"X": [g.i(B, S, lo=-99, hi=99)]},
                                             outs=(("Out", "INT32"),)))
    case("range", lambda g: OpTestCase("range", {}, {"start": -1.5, "end": 0.25 * S,
                                                     "step": 0.3}))
    case("linspace", lambda g: OpTestCase("linspace", {}, {"start": 0.0, "stop": 2.7,
                                                           "num": 4 * S + 1}))
    case("fill_constant_batch_size_like", lambda g: OpTestCase(
        "fill_constant_batch_size_like", {"Input": [g.n(B, S)]},
        {"shape": [-1, C], "value": 0.5, "input_dim_idx": 0, "output_dim_idx": 0}))
    case("assign_value", lambda g: OpTestCase(
        "assign_value", {}, {"shape": [2, 3], "int32_values": [1, -2, 3, 4, 5, 6],
                             "dtype": "int32"}, outs=(("Out", "INT32"),)))
    case("expand_v2", lambda g: OpTestCase("expand_v2", {"X": [g.n(B, 1, C)]},
                                           {"shape": [2, B, S, -1]}))
    case("expand_as_v2", lambda g: OpTestCase(
        "expand_as_v2", {"X": [g.n(1, S, 1)], "Y": [g.n(B, S, C)]}))
    case("scatter", lambda g: OpTestCase(
        "scatter", {"X": [g.n(V, C)], "Ids": [g.rng.permutation(V)[:B].astype(np.int32)],
                    "Updates": [g.n(B, C)]}, {"overwrite": True}))
    case("scatter_nd_add", lambda g: OpTestCase(
        "scatter_nd_add", {"X": [g.n(B, S, C)], "Index": [g.i(2 * B, 2, hi=min(B, S))],
                           "Updates": [g.n(2 * B, C)]}, exact=False))
    case("gather_nd", lambda g: OpTestCase(
        "gather_nd", {"X": [g.n(B, S, C)], "Index": [g.i(B, 3, 2, lo=-2, hi=min(B, S))]}))
    case("index_select", lambda g: OpTestCase(
        "index_select", {"X": [g.n(B, S, C)], "Index": [g.i(4, lo=0, hi=S)]}, {"dim": 1}))
    case("strided_slice", lambda g: OpTestCase(
        "strided_slice", {"X": [g.n(B, S, C)]},
        {"axes": [1, 2], "starts": [-1, 0], "ends": [0, C], "strides": [-2, 2]}))
    for name in ("flip", "reverse"):
        case(name, lambda g, name=name: OpTestCase(name, {"X": [g.n(B, S, C)]}, {"axis": [0, 2]}))
    case("roll", lambda g: OpTestCase("roll", {"X": [g.n(B, S, C)]},
                                      {"shifts": [2, -1], "axis": [1, 2]}))
    case("unbind", lambda g: OpTestCase("unbind", {"X": [g.n(B, 3, C)]}, {"axis": 1},
                                        outs=(("Out", "FP32"),) * 3))
    for name in ("crop", "crop_tensor"):
        case(name, lambda g, name=name: OpTestCase(
            name, {"X": [g.n(B, S, C)]}, {"shape": [1, S - 2, C], "offsets": [B, 1, 0]}))
    case("argsort", lambda g: OpTestCase(
        "argsort", {"X": [g.i(B, S, C, hi=4).astype(F32)]}, {"axis": 1, "descending": True},
        outs=(("Out", "FP32"), ("Indices", "INT64"))))
    case("arg_min", lambda g: OpTestCase(
        "arg_min", {"X": [g.i(B, S, C, hi=3).astype(F32)]}, {"axis": 1, "keepdims": False},
        outs=(("Out", "INT64"),)))
    case("mean", lambda g: OpTestCase("mean", {"X": [g.n(B, S, C)]}, exact=False))
    case("size", lambda g: OpTestCase("size", {"Input": [g.n(B, S, C)]},
                                      outs=(("Out", "INT64"),)))
    case("p_norm", lambda g: OpTestCase("p_norm", {"X": [g.n(B, S, C)]},
                                        {"porder": 3.0, "axis": 1}, exact=False))
    case("cos_sim", lambda g: OpTestCase("cos_sim", {"X": [g.n(B, S, C)], "Y": [g.n(B, S, C)]},
                                         exact=False))
    case("affine_channel", lambda g: OpTestCase(
        "affine_channel", {"X": [x4(g)], "Scale": [g.n(C)], "Bias": [g.n(C)]}, exact=False))
    case("pixel_unshuffle", lambda g: OpTestCase("pixel_unshuffle", {"X": [x4(g)]},
                                                 {"downscale_factor": 2}))
    case("pad3d", lambda g: OpTestCase("pad3d", {"X": [g.n(B, 3, S, S, C)]},
                                       {"paddings": [1, 0, 0, 2, 1, 1], "value": 0.5}))
    case("max_pool2d_with_index", lambda g: OpTestCase(
        "max_pool2d_with_index", {"X": [x4(g)]},
        {"ksize": [3, 3], "strides": [2, 2], "paddings": [0, 0]},
        outs=(("Out", "FP32"), ("Mask", "INT32"))))
    case("grid_sampler", lambda g: OpTestCase(
        "grid_sampler", {"X": [x4(g)], "Grid": [g.u(B, S - 1, S + 1, 2, lo=-1.1, hi=1.1)]},
        {"align_corners": False}, outs=(("Output", "FP32"),), exact=False))
    case("uniform_random", lambda g: OpTestCase(
        "uniform_random", {}, {"shape": [B, S, C], "min": -2.0, "max": 3.0, "seed": 7}))
    case("gaussian_random", lambda g: OpTestCase(
        "gaussian_random", {}, {"shape": [B, S, C], "mean": 0.5, "std": 2.0, "seed": 11},
        exact=False))

    # ---- plumbing -------------------------------------------------------------------------------------
    for name in ("feed", "fetch", "io_copy", "io_copy_once"):
        case(name, lambda g, name=name: OpTestCase(name, {"X": [g.n(B, S, C)]}))
    case("layout", lambda g: OpTestCase("layout", {"X": [g.n(B, C, S, S)]}, {"to": "nhwc"}))

    # ---- control flow ---------------------------------------------------------------------------------
    case("while", lambda g: OpTestCase(
        "while", {"X": [np.ones((1,), np.bool_), np.zeros((1,), F32)]},
        {"block": _loop_block(float(S)), "cond_index": 0, "max_iters": 4 * S},
        outs=(("Out", "BOOL"), ("Out", "FP32"))))
    case("conditional_block", lambda g: OpTestCase(
        "conditional_block", {"Cond": [np.ones((1,), np.bool_)], "Input": [g.n(B, C)]},
        {"block": _affine_block((B, C))}, exact=False))
    case("subgraph", lambda g: OpTestCase(
        "subgraph", {"Inputs": [g.n(B, C)]}, {"graph": _affine_block((B, C))},
        outs=(("Outputs", "FP32"),), exact=False))
    case("split_lod_tensor", lambda g: OpTestCase(
        "split_lod_tensor", {"X": [g.n(B, S, C)], "Mask": [g.b(B, 1)]},
        outs=(("OutTrue", "FP32"), ("OutFalse", "FP32"))))
    case("merge_lod_tensor", lambda g: OpTestCase(
        "merge_lod_tensor", {"Mask": [g.b(B, 1)], "InTrue": [g.n(B, S, C)],
                             "InFalse": [g.n(B, S, C)]}))
    return out
