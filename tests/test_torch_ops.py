"""Each main-path op under the port's ``"torch"`` tag against the JAX
package's ``"xla"`` impl, on one-op graphs built with the reference's IR and
carried across with ``graph_from_reference`` (so both run the identical op,
attrs and scales).  Inputs are made with numpy from a seed.

Tolerances: integer outputs exactly; fp32 outputs rtol 1e-5 — fp32 conv and
matmul sums run in another order in XLA and in torch (softmax, fp32 convs,
batch_norm, avg pools).  An int8 output of an fp32 conv is requantized from
such sums, so it may flip at a rounding tie: at most 0.1% of its elements,
by 1 LSB.
"""

import numpy as np
import pytest
import torch

import jax

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.ir import Graph as RGraph
from paddle_lite_tpu.core.types import Precision as RPrecision
from paddle_lite_tpu.core.types import QuantInfo as RQuant
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.ops import common as pc

CPU = torch.device("cpu")
RTOL = 1e-5


def _run_both(g: RGraph, feed):
    g.rebuild_links()
    ref = R.build_callable(g, platform="cpu")(R.stage_weights(g), feed)
    ref = {k: np.asarray(jax.device_get(v)) for k, v in ref.items()}
    gp = graph_from_reference(artifact.graph_to_meta(g), g.weights)
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)
    return ref, {k: v.numpy() for k, v in got.items()}


def _assert_match(ref, got, tie_ok=False):
    for k in ref:
        r, g = ref[k], got[k]
        assert r.shape == g.shape and r.dtype == g.dtype, k
        if r.dtype == np.int8:
            d = np.abs(r.astype(np.int32) - g.astype(np.int32))
            if tie_ok:
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3
            else:
                np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-6)


def _graph(x_shape, x_prec=RPrecision.FP32, x_scale=None):
    g = RGraph("t")
    v = g.add_var("x", x_shape, precision=x_prec)
    if x_scale is not None:
        v.quant = RQuant.per_tensor(x_scale)
    g.inputs.append("x")
    return g


def _out(g, name, shape, int8_scale=None):
    v = g.add_var(name, shape, precision=RPrecision.INT8 if int8_scale
                  else RPrecision.FP32)
    if int8_scale:
        v.quant = RQuant.per_tensor(int8_scale)
    g.outputs.append(name)


def _int8_input(rng, shape):
    return rng.integers(-127, 128, size=shape, dtype=np.int8)


def _add_int8_weight(g, rng, name, shape, axis):
    w = g.add_weight(name, rng.integers(-127, 128, size=shape, dtype=np.int8))
    w.quant = RQuant.per_channel_scales(
        rng.uniform(0.5e-3, 2e-3, size=shape[axis]).astype(np.float32), axis)


@pytest.mark.parametrize("op_type,k,stride", [
    ("conv2d", 1, 1),                # pointwise
    ("conv2d", 3, 2),                # dense 3x3 stride 2
    ("depthwise_conv2d", 3, 1),
    ("depthwise_conv2d", 3, 2),
    ("depthwise_conv2d", 5, 1),
])
@pytest.mark.parametrize("act,out_int8", [("relu", True), ("relu6", True),
                                          (None, False)])
def test_int8_conv(op_type, k, stride, act, out_int8):
    rng = np.random.default_rng(k * 10 + stride)
    c, oc = 16, (16 if op_type == "depthwise_conv2d" else 24)
    g = _graph((2, 9, 9, c), RPrecision.INT8, x_scale=0.02)
    w_shape = (k, k, c, oc) if op_type == "conv2d" else (k, k, 1, c)
    _add_int8_weight(g, rng, "w", w_shape, axis=3)
    g.add_weight("b", rng.normal(0, 0.3, size=(oc,)).astype(np.float32))
    oh = (9 + 2 * (k // 2) - k) // stride + 1
    _out(g, "y", (2, oh, oh, oc), int8_scale=0.05 if out_int8 else None)
    attrs = {"strides": [stride, stride], "paddings": [k // 2, k // 2],
             "dilations": [1, 1], "groups": 1, "enable_int8": True}
    if act:
        attrs["fuse_act"] = act
    if out_int8:
        attrs["out_scale"] = 0.05
    g.add_op(op_type, {"Input": ["x"], "Filter": ["w"], "Bias": ["b"]},
             {"Output": ["y"]}, attrs)
    ref, got = _run_both(g, {"x": _int8_input(rng, (2, 9, 9, c))})
    _assert_match(ref, got)


@pytest.mark.parametrize("out_int8", [True, False])
def test_fp32_stem_conv(out_int8):
    """The fp32 3x3 / s2 stem with relu, optionally requantized to int8."""
    rng = np.random.default_rng(0)
    g = _graph((2, 16, 16, 3))
    g.add_weight("w", rng.normal(0, 0.3, size=(3, 3, 3, 8)).astype(np.float32))
    g.add_weight("b", rng.normal(0, 0.1, size=(8,)).astype(np.float32))
    _out(g, "y", (2, 8, 8, 8), int8_scale=0.02 if out_int8 else None)
    attrs = {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1, "fuse_act": "relu"}
    if out_int8:
        attrs["out_scale"] = 0.02
    g.add_op("conv2d", {"Input": ["x"], "Filter": ["w"], "Bias": ["b"]},
             {"Output": ["y"]}, attrs)
    ref, got = _run_both(g, {"x": rng.normal(size=(2, 16, 16, 3)).astype(np.float32)})
    _assert_match(ref, got, tie_ok=out_int8)


@pytest.mark.parametrize("op_type", ["fc", "mul"])
@pytest.mark.parametrize("int8", [True, False])
def test_fc_and_mul(op_type, int8):
    rng = np.random.default_rng(1)
    g = _graph((4, 64), RPrecision.INT8 if int8 else RPrecision.FP32,
               x_scale=0.03 if int8 else None)
    if int8:
        _add_int8_weight(g, rng, "w", (64, 10), axis=1)
        x = _int8_input(rng, (4, 64))
    else:
        g.add_weight("w", rng.normal(size=(64, 10)).astype(np.float32))
        x = rng.normal(size=(4, 64)).astype(np.float32)
    g.add_weight("b", rng.normal(size=(10,)).astype(np.float32))
    _out(g, "y", (4, 10))
    attrs = {"enable_int8": True} if int8 else {}
    if op_type == "fc":
        g.add_op("fc", {"Input": ["x"], "W": ["w"], "Bias": ["b"]},
                 {"Out": ["y"]}, dict(attrs, in_num_col_dims=1))
    else:
        g.add_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["y"]},
                 dict(attrs, x_num_col_dims=1, y_num_col_dims=1))
    ref, got = _run_both(g, {"x": x})
    _assert_match(ref, got)


def test_batch_norm():
    rng = np.random.default_rng(2)
    g = _graph((2, 5, 5, 6))
    for n, v in (("s", 1 + 0.1 * rng.normal(size=6)), ("b", rng.normal(size=6)),
                 ("m", 0.1 * rng.normal(size=6)), ("v", 1 + np.abs(rng.normal(size=6)))):
        g.add_weight(n, v.astype(np.float32))
    _out(g, "y", (2, 5, 5, 6))
    g.add_op("batch_norm", {"X": ["x"], "Scale": ["s"], "Bias": ["b"],
                            "Mean": ["m"], "Variance": ["v"]}, {"Y": ["y"]}, {})
    ref, got = _run_both(g, {"x": rng.normal(size=(2, 5, 5, 6)).astype(np.float32)})
    _assert_match(ref, got)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("attrs,out_hw", [
    (dict(pooling_type="avg", global_pooling=True), 1),
    (dict(pooling_type="max", global_pooling=True), 1),
    (dict(pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[1, 1]), 4),
    (dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
          exclusive=True), 4),
    (dict(pooling_type="avg", ksize=[2, 2], strides=[2, 2], paddings=[0, 0],
          exclusive=False, ceil_mode=True), 4),
])
def test_pool2d(int8, attrs, out_hw):
    rng = np.random.default_rng(3)
    g = _graph((2, 7, 7, 5), RPrecision.INT8 if int8 else RPrecision.FP32,
               x_scale=0.1 if int8 else None)
    _out(g, "y", (2, out_hw, out_hw, 5), int8_scale=0.1 if int8 else None)
    g.add_op("pool2d", {"X": ["x"]}, {"Out": ["y"]}, attrs)
    x = (_int8_input(rng, (2, 7, 7, 5)) if int8
         else rng.normal(size=(2, 7, 7, 5)).astype(np.float32))
    ref, got = _run_both(g, {"x": x})
    _assert_match(ref, got)


def test_global_avg_pool_rounds_half_to_even():
    # sums of 4 elements / 4 land exactly on .5: jnp.round -> even
    g = _graph((1, 2, 2, 4), RPrecision.INT8, x_scale=0.1)
    _out(g, "y", (1, 1, 1, 4), int8_scale=0.1)
    g.add_op("pool2d", {"X": ["x"]}, {"Out": ["y"]},
             dict(pooling_type="avg", global_pooling=True))
    x = np.zeros((1, 2, 2, 4), np.int8)
    x[0, :, :, 0] = [[1, 1], [0, 0]]  # 2/4 = 0.5 -> 0
    x[0, :, :, 1] = [[3, 3], [0, 0]]  # 6/4 = 1.5 -> 2
    x[0, :, :, 2] = [[5, 5], [0, 0]]  # 10/4 = 2.5 -> 2
    x[0, :, :, 3] = -1
    ref, got = _run_both(g, {"x": x})
    _assert_match(ref, got)
    assert got["y"].reshape(-1)[:3].tolist() == [0, 2, 2]


def test_softmax_reshape_and_acts():
    rng = np.random.default_rng(4)
    g = _graph((2, 1, 1, 12))
    g.add_var("r", (2, 12))
    g.add_var("a", (2, 12))
    g.add_var("a6", (2, 12))
    _out(g, "y", (2, 12))
    g.add_op("reshape", {"X": ["x"]}, {"Out": ["r"]}, {"shape": [2, 12]})
    g.add_op("relu", {"X": ["r"]}, {"Out": ["a"]}, {})
    g.add_op("relu6", {"X": ["a"]}, {"Out": ["a6"]}, {})
    g.add_op("softmax", {"X": ["a6"]}, {"Out": ["y"]}, {"axis": -1})
    g.outputs.extend(["a", "a6"])
    ref, got = _run_both(g, {"x": 5 * rng.normal(size=(2, 1, 1, 12)).astype(np.float32)})
    _assert_match(ref, got)


def test_quantize_dequantize_ops():
    rng = np.random.default_rng(5)
    g = _graph((3, 40))
    q = g.add_var("q", (3, 40), precision=RPrecision.INT8)
    q.quant = RQuant.per_tensor(0.013)
    _out(g, "y", (3, 40))
    g.add_op("quantize", {"X": ["x"]}, {"Out": ["q"]}, {})
    g.add_op("dequantize", {"X": ["q"]}, {"Out": ["y"]}, {})
    g.outputs.append("q")
    x = rng.normal(size=(3, 40)).astype(np.float32)
    x[0, :4] = np.array([0.5, 1.5, 2.5, -0.5], np.float32) * np.float32(0.013)
    ref, got = _run_both(g, {"x": x})
    _assert_match(ref, got)


@pytest.mark.parametrize("act", ["relu", "relu6", "leaky_relu", "sigmoid",
                                 "hard_swish", "hard_sigmoid", "swish", "tanh"])
def test_apply_activation_matches(act):
    from paddle_lite_tpu.ops.common import apply_activation as r_act

    x = np.random.default_rng(6).normal(0, 4, size=(64,)).astype(np.float32)
    ref = np.asarray(r_act(x, act, {}))
    got = pc.apply_activation(torch.from_numpy(x), act, {}).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)
