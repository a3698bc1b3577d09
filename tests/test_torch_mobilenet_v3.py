"""MobileNetV3-Large INT8 through both packages: the model, its optimized
graph, the epilogue's new activations and the elementwise ops.

Small sizes (batch 2, 64 px); inputs are made with numpy from a seed and
handed to both packages.

Tolerances, and why:
- graphs and weights: identical; the optimized graph is compared from the
  same calibration scales (the JAX package's), so scales match exactly.
- the epilogue (leaky_relu, hard_swish, hard_sigmoid) against the JAX
  ``_epilogue``: int8 outputs may differ at requant ties by 1 LSB in at
  most ``TIE_COUNT`` elements (JAX may contract ``slope·y + offset`` or
  ``acc·s + b`` into one FMA, one fp32 ulp off the port's separate
  roundings); fp32 outputs rtol 1e-6 (the same ulp).
- elementwise ops: integer outputs exact, fp32 rtol 1e-6.
- end to end: logits cosine > 0.999 against the JAX package's int8 graph
  (ties spread, as in ``test_torch_main_path.py``), and > 0.96 int8 against
  the port's own fp32 predictor (``tests/test_model_zoo_int8.py:38``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.ir import Graph as RGraph
from paddle_lite_tpu.core.pass_manager import PassManager as RPassManager
from paddle_lite_tpu.core.types import Precision as RPrecision
from paddle_lite_tpu.core.types import QuantInfo as RQuant
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.models import mobilenet_v3 as r_mnv3
from paddle_lite_tpu.ops.kernels.int8_matmul import _epilogue as r_epilogue
from paddle_lite_tpu.quant.calibrate import calibrate as r_calibrate
from paddle_lite_tpu.tools.opt import FUSION_PASSES as R_FUSION
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import mobilenet_v3 as p_mnv3
from paddle_lite_tpu_torch.ops.kernels import depthwise, int8_matmul
from paddle_lite_tpu_torch.ops.kernels.select import gemm_eligible
from paddle_lite_tpu_torch.quant.calibrate import CalibrationResult
from paddle_lite_tpu_torch.runtime.predictor import create_predictor
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
TIE_COUNT = 2
FP32_RTOL = 1e-6
KW = dict(batch=2, image_size=64, num_classes=50, seed=5, with_softmax=False)


def _feeds(n, seed, size=64):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(2, size, size, 3)).astype(np.float32)}
            for _ in range(n)]


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _assert_same_graph(gr, gp, skip_attrs=()):
    assert [o.op_type for o in gr.ops] == [o.op_type for o in gp.ops]
    for a, b in zip(gr.ops, gp.ops):
        assert a.inputs == b.inputs and a.outputs == b.outputs
        ka = {k: v for k, v in a.attrs.items() if k not in skip_attrs}
        kb = {k: v for k, v in b.attrs.items() if k not in skip_attrs}
        assert ka == kb, (a.op_type, ka, kb)
    assert gr.inputs == gp.inputs and gr.outputs == gp.outputs
    assert sorted(gr.vars) == sorted(gp.vars)
    for n, v in gr.vars.items():
        w = gp.vars[n]
        assert v.shape == w.shape and v.is_weight == w.is_weight, n
        assert v.precision.value == w.precision.value, n
        assert (v.quant is None) == (w.quant is None), n
        if v.quant is not None:
            assert v.quant.scale == w.quant.scale and v.quant.axis == w.quant.axis, n
    assert sorted(gr.weights) == sorted(gp.weights)
    for n in gr.weights:
        a, b = np.asarray(gr.weights[n]), np.asarray(gp.weights[n])
        assert a.dtype == b.dtype and np.array_equal(a, b), n


# ---- the model -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    KW,
    dict(batch=1, image_size=32, seed=1, ablate_se=True, ablate_hs=True),
    dict(batch=1, image_size=32, seed=2, ablate_dw=True),
])
def test_build_identical(kw):
    _assert_same_graph(r_mnv3.build(**kw), p_mnv3.build(**kw))


def _optimized_pair():
    """Both packages' optimized graphs from the JAX package's scales."""
    calib = _feeds(2, 1)
    seen = r_mnv3.build(**KW)
    RPassManager(R_FUSION).run(seen)
    result = r_calibrate(seen, calib)
    gr, gp = r_mnv3.build(**KW), p_mnv3.build(**KW)
    r_optimize(gr, quant=R.QuantConfig(), calib_result=result)
    optimize(gp, quant=P.QuantConfig(), device="cpu",
             calib_result=CalibrationResult(scales=dict(result.scales)))
    return gr, gp


def test_optimized_graph_matches_reference():
    """Same op types, attrs, int8 marks, scales and int8 weights; the port
    tags every int8 op "cuda": 48 GEMMs (13 relu, 11 hard_swish, 8
    hard_sigmoid SE gates with fp32 out, 5 without an activation, the 10
    residual 1x1 convs without one, the int8 residual in the GEMM's
    epilogue, the fc) and all 15 depthwise convs."""
    gr, gp = _optimized_pair()
    _assert_same_graph(gr, gp, skip_attrs=("kernel",))
    cuda = [o for o in gp.ops if o.attrs.get("kernel") == "cuda"]
    dw = [o for o in cuda if o.op_type == "depthwise_conv2d"]
    gemm = [o for o in cuda if o.op_type != "depthwise_conv2d"]
    assert len(gemm) == 48 and len(dw) == 15
    acts = [o.attrs.get("fuse_act") for o in gemm]
    assert (acts.count("relu"), acts.count("hard_swish"), acts.count("hard_sigmoid"),
            acts.count(None)) == (13, 11, 8, 16)
    residual = [o for o in gemm if o.maybe_input("ResidualData")]
    assert len(residual) == 10 and all(o.attrs.get("fuse_act") is None for o in residual)
    assert all(o.attrs.get("out_scale") for o in residual)
    # no int8 op is left on the torch path
    for o in gp.ops:
        if o.attrs.get("enable_int8"):
            assert o.attrs.get("kernel") == "cuda", o.op_type
            assert o.op_type == "depthwise_conv2d" or gemm_eligible(gp, o)
    gates = [o for o in gemm if o.attrs.get("fuse_act") == "hard_sigmoid"]
    assert all(o.attrs.get("out_scale") is None for o in gates)
    assert all(o.attrs["act_attrs"] == {"slope": 0.2, "offset": 0.5} for o in gates)
    muls = [o for o in gp.ops if o.op_type == "elementwise_mul"]
    assert len(muls) == 8 and all(o.attrs.get("out_scale") for o in muls)


# ---- the epilogue's new activations against the JAX _epilogue --------------

@pytest.mark.parametrize("act,attrs", [
    ("leaky_relu", {"alpha": 0.1}),
    ("leaky_relu", {}),
    ("hard_swish", {}),
    ("hard_swish", {"threshold": 5.0, "scale": 7.0, "offset": 2.5}),
    ("hard_sigmoid", {"slope": 0.2, "offset": 0.5}),
    ("hard_sigmoid", {"slope": 1.0 / 6, "offset": 0.5}),
])
@pytest.mark.parametrize("int8_out", [True, False])
def test_epilogue_vs_reference(act, attrs, int8_out):
    rng = np.random.default_rng(11)
    acc = rng.integers(-2_000_000, 2_000_000, size=(96, 80)).astype(np.int32)
    scale = rng.uniform(1e-6, 8e-6, size=80).astype(np.float32)
    bias = rng.normal(0, 1.0, size=80).astype(np.float32)
    out_scale = 0.05 if int8_out else None
    ref = np.asarray(r_epilogue(jnp.asarray(acc), jnp.asarray(scale), jnp.asarray(bias),
                                act, attrs, out_scale, jnp.float32))
    got = int8_matmul.epilogue(torch.from_numpy(acc).to(torch.float32),
                               torch.from_numpy(scale), torch.from_numpy(bias),
                               act, attrs, out_scale).numpy()
    assert got.dtype == ref.dtype
    if int8_out:
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert d.max() <= 1 and (d > 0).sum() <= TIE_COUNT
    else:
        np.testing.assert_allclose(got, ref, rtol=FP32_RTOL, atol=1e-6)


@pytest.mark.parametrize("act", ["leaky_relu", "hard_swish", "hard_sigmoid"])
def test_kernels_plain_versions_take_activation_attrs(act):
    """The GEMM and depthwise wrappers apply the activation's attrs (CPU:
    the plain versions; ``chip_smoke.py`` holds the kernels to them)."""
    attrs = {"leaky_relu": {"alpha": 0.3}, "hard_swish": {"offset": 2.0},
             "hard_sigmoid": {"slope": 0.5, "offset": 0.25}}[act]
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(-127, 128, size=(2, 6, 6, 8), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(5, 5, 1, 8), dtype=np.int8))
    eff = torch.full((8,), 1e-3)
    y = depthwise.dw_conv_int8(x, w, eff, act=act, act_attrs=attrs)
    y0 = depthwise.dw_conv_int8(x, w, eff, act=act)
    assert not torch.equal(y, y0)
    from paddle_lite_tpu_torch.ops.common import apply_activation

    acc = depthwise.dw_conv_int8(x, w, torch.ones(8))
    assert torch.equal(y, apply_activation(acc * eff, act, attrs))
    g = int8_matmul.int8_matmul(x.reshape(-1, 8), w.reshape(25, 8)[:8], eff,
                                act=act, act_attrs=attrs)
    assert g.shape == (72, 8)


# ---- elementwise / scale / clip / cast / compare ---------------------------

def _run_both(g: RGraph, feed):
    g.rebuild_links()
    ref = R.build_callable(g, platform="cpu")(R.stage_weights(g), feed)
    ref = {k: np.asarray(jax.device_get(v)) for k, v in ref.items()}
    gp = graph_from_reference(artifact.graph_to_meta(g), g.weights)
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)
    return ref, {k: v.numpy() for k, v in got.items()}


def _assert_match(ref, got):
    for k in ref:
        r, g = ref[k], got[k]
        assert r.shape == g.shape and r.dtype == g.dtype, (k, r.dtype, g.dtype)
        if r.dtype.kind in "iub":
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=FP32_RTOL, atol=1e-6)


def _one_op(op_type, x_shape, y_shape, attrs, *, x=None, y=None, out_shape=None,
            x_int8=None, y_int8=None, out_int8=None, out_prec=RPrecision.FP32):
    g = RGraph("t")
    rng = np.random.default_rng(13)
    feed = {}
    for name, shape, scale, val in (("x", x_shape, x_int8, x), ("y", y_shape, y_int8, y)):
        if shape is None:
            continue
        v = g.add_var(name, shape, precision=RPrecision.INT8 if scale is not None
                      else RPrecision.FP32)
        if scale is not None:
            v.quant = (RQuant.per_channel_scales(scale, len(shape) - 1)
                       if np.ndim(scale) else RQuant.per_tensor(scale))
            val = rng.integers(-127, 128, size=shape, dtype=np.int8) if val is None else val
        elif val is None:
            val = rng.normal(0, 2, size=shape).astype(np.float32)
        g.inputs.append(name)
        feed[name] = val
    o = g.add_var("out", out_shape or x_shape,
                  precision=RPrecision.INT8 if out_int8 else out_prec)
    if out_int8:
        o.quant = RQuant.per_tensor(out_int8)
        attrs = dict(attrs, out_scale=out_int8)
    g.outputs.append("out")
    ins = {"X": ["x"]}
    if y_shape is not None:
        ins["Y"] = ["y"]
    g.add_op(op_type, ins, {"Out": ["out"]}, attrs)
    return g, feed


@pytest.mark.parametrize("kind", ["add", "sub", "mul", "div", "max", "min",
                                  "pow", "mod", "floordiv"])
def test_elementwise_fp32(kind):
    y = None
    if kind in ("pow", "mod", "floordiv", "div"):
        y = np.random.default_rng(14).uniform(0.5, 2.0, size=(4, 1, 6)).astype(np.float32)
    x = np.abs(np.random.default_rng(15).normal(0, 2, size=(2, 4, 5, 6))).astype(np.float32) \
        if kind == "pow" else None
    g, feed = _one_op(f"elementwise_{kind}", (2, 4, 5, 6), (4, 1, 6), {"axis": 1},
                      x=x, y=y)
    _assert_match(*_run_both(g, feed))


@pytest.mark.parametrize("case", ["se_gate", "per_channel_y", "both_int8_act"])
def test_elementwise_int8(case):
    """The SE gate multiply (int8 data, fp32 gate, int8 out), a per-channel
    int8 Y, and two int8 operands with a fused activation."""
    if case == "se_gate":
        g, feed = _one_op("elementwise_mul", (2, 5, 5, 8), (2, 1, 1, 8), {"axis": -1},
                          x_int8=0.04, out_int8=0.03,
                          y=np.random.default_rng(16).uniform(0, 1, (2, 1, 1, 8))
                          .astype(np.float32))
    elif case == "per_channel_y":
        scales = np.random.default_rng(17).uniform(0.01, 0.05, 8).astype(np.float32)
        g, feed = _one_op("elementwise_add", (2, 5, 5, 8), (2, 5, 5, 8), {"axis": -1},
                          y_int8=scales)
    else:
        g, feed = _one_op("elementwise_add", (2, 5, 5, 8), (2, 5, 5, 8),
                          {"axis": -1, "fuse_act": "relu"}, x_int8=0.02, y_int8=0.03,
                          out_int8=0.04)
    _assert_match(*_run_both(g, feed))


@pytest.mark.parametrize("attrs", [dict(scale=2.5, bias=0.75),
                                   dict(scale=0.5, bias=-1.0, bias_after_scale=False)])
@pytest.mark.parametrize("int8", [True, False])
def test_scale(attrs, int8):
    g, feed = _one_op("scale", (3, 7), None, attrs, x_int8=0.02 if int8 else None)
    _assert_match(*_run_both(g, feed))


def test_clip_and_cast():
    g, feed = _one_op("clip", (3, 7), None, {"min": -0.5, "max": 1.5})
    _assert_match(*_run_both(g, feed))
    for dtype in ("int32", "float32", "bool"):
        g, feed = _one_op("cast", (3, 7), None, {"out_dtype": dtype},
                          out_prec=RPrecision.FP32)
        ref, got = _run_both(g, feed)
        assert got["out"].dtype == np.dtype(dtype)
        _assert_match(ref, got)


@pytest.mark.parametrize("op_type", ["less_than", "less_equal", "greater_than",
                                     "greater_equal", "equal", "not_equal",
                                     "logical_and", "logical_or", "logical_xor"])
def test_compare_and_logical(op_type):
    rng = np.random.default_rng(18)
    x = rng.integers(-2, 3, size=(3, 4)).astype(np.float32)
    y = rng.integers(-2, 3, size=(4,)).astype(np.float32)
    g, feed = _one_op(op_type, (3, 4), (4,), {"axis": -1}, x=x, y=y)
    _assert_match(*_run_both(g, feed))


@pytest.mark.parametrize("act,attrs", [
    ("hard_sigmoid", {"slope": 0.2, "offset": 0.5}),   # as mobilenet_v3._se writes it
    ("hard_swish", {"threshold": 5.0, "scale": 7.0, "offset": 2.5}),
    ("leaky_relu", {"alpha": 0.3}),
])
@pytest.mark.parametrize("int8_in", [True, False])
def test_standalone_activation_attrs(act, attrs, int8_in):
    """Standalone activation ops read their attrs as the builder writes them."""
    g, feed = _one_op(act, (3, 7), None, attrs, x_int8=0.05 if int8_in else None)
    _assert_match(*_run_both(g, feed))


def test_logical_not():
    x = np.random.default_rng(19).integers(0, 2, size=(5,)).astype(bool)
    g, feed = _one_op("logical_not", (5,), None, {}, x=x)
    _assert_match(*_run_both(g, feed))


# ---- end to end --------------------------------------------------------------

def test_int8_end_to_end_vs_reference_and_fp32():
    gr, gp = _optimized_pair()
    feed = _feeds(1, 3)[0]
    out = gr.outputs[0]
    ref = np.asarray(jax.device_get(
        R.build_callable(gr, platform="cpu")(R.stage_weights(gr), feed)[out]))
    int8_matmul.launches = depthwise.launches = 0
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)[out].numpy()
    assert int8_matmul.launches == 0 and depthwise.launches == 0  # CPU: plain
    assert got.shape == (2, 50) and np.isfinite(got).all()
    assert _cos(got, ref) > 0.999
    fp32 = create_predictor(p_mnv3.build(**KW), device="cpu").run(feed)[out].numpy()
    assert _cos(got, fp32) > 0.96
