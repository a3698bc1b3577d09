"""The 38 op names the fluid converter can emit that the port lacked, each
against the reference's ``"xla"`` impl on seeded random inputs.

Each op runs as a one-op graph through both packages' eager executors on
the CPU, so its shape function, its impl and the executor's input casts are
all held to the reference.  Tolerances:
- data movement, integer and boolean results, and ops whose float
  arithmetic is one IEEE operation an element: equal, bit for bit;
- float results of transcendental functions or reductions (erf, sin, cos,
  sigmoid and exp in ``yolo_box``, sums and means in another order): rtol
  1e-5, atol 1e-6.

Where the port deliberately departs from a reference fault, the test says
so and holds the port to the correct result: ``bilinear_interp_v2``
(bilinear here, nearest there), ``reduce_*`` with ``reduce_all``,
``arg_max`` with ``keepdims``, ``density_prior_box``'s count with several
ratios and ``yolo_box``'s ``clip_bbox`` at batch > 1.
"""

import inspect
import re

import jax
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.ir import Graph as RGraph
from paddle_lite_tpu.core.registry import OPS as ROPS
from paddle_lite_tpu.core.types import Precision as RPrecision
from paddle_lite_tpu.core.types import QuantInfo as RQuant
from paddle_lite_tpu_torch.core.ir import Graph as PGraph
from paddle_lite_tpu_torch.core.registry import OPS as POPS
from paddle_lite_tpu_torch.core.types import Precision as PPrecision
from paddle_lite_tpu_torch.core.types import QuantInfo as PQuant
from paddle_lite_tpu_torch.formats import fluid_convert

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6

_PREC = {np.dtype(np.float32): "FP32", np.dtype(np.int32): "INT32",
         np.dtype(np.int64): "INT64", np.dtype(np.bool_): "BOOL",
         np.dtype(np.int8): "INT8"}


def _graph(pkg, op_type, inputs, attrs, outs, scales):
    G, OPS, Prec, Quant = ((RGraph, ROPS, RPrecision, RQuant) if pkg == "ref"
                           else (PGraph, POPS, PPrecision, PQuant))
    g = G("one_op")
    names = {}
    for slot, arrs in inputs.items():
        names[slot] = []
        for i, a in enumerate(arrs):
            n = f"{slot.lower()}{i}"
            v = g.add_var(n, a.shape, precision=Prec[_PREC[a.dtype]])
            if n in scales:
                v.quant = Quant.per_tensor(scales[n])
            g.inputs.append(n)
            names[slot].append(n)
    shapes = OPS.get(op_type).infer_shape(
        attrs, [a.shape for arrs in inputs.values() for a in arrs])
    out_names = {}
    for (slot, prec), shape in zip(outs, shapes):
        n = f"out_{slot.lower()}{len(out_names)}"
        g.add_var(n, shape, precision=Prec[prec])
        out_names.setdefault(slot, []).append(n)
        g.outputs.append(n)
    g.add_op(op_type, names, out_names, dict(attrs))
    g.rebuild_links()
    return g


def run_port(op_type, inputs, attrs, outs=(("Out", "FP32"),)):
    """The port's outputs alone (where the reference fails)."""
    feed = {f"{s.lower()}{i}": a for s, arrs in inputs.items() for i, a in enumerate(arrs)}
    gp = _graph("port", op_type, inputs, attrs, outs, {})
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)
    return [got[n].numpy() for n in gp.outputs]


def run_both(op_type, inputs, attrs, outs=(("Out", "FP32"),), scales=None):
    """(reference outputs, port outputs), numpy, in the graph's output
    order; `inputs` maps slot -> arrays, `outs` lists (slot, precision)."""
    scales = scales or {}
    feed = {f"{s.lower()}{i}": a for s, arrs in inputs.items() for i, a in enumerate(arrs)}
    gr = _graph("ref", op_type, inputs, attrs, outs, scales)
    gp = _graph("port", op_type, inputs, attrs, outs, scales)
    want = R.build_callable(gr, platform="cpu")(R.stage_weights(gr), feed)
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)
    return ([np.asarray(jax.device_get(want[n])) for n in gr.outputs],
            [got[n].numpy() for n in gp.outputs])


def assert_same(want, got, exact):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if g.dtype == np.int64 and w.dtype == np.int32:
            w = w.astype(np.int64)  # jax without x64 gives int64 results as int32
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _x(shape, seed=0, scale=1.0):
    return (_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ---- the cases: (op_type, inputs, attrs, outs, exact, scales) ----------------

X4 = _x((2, 5, 6, 3))
X3 = _x((2, 4, 5), seed=1)
HALVES = np.array([[-2.5, -1.5, -0.5, 0.0, 0.5, 1.5, 2.5, 3.7, -3.2, -0.0]], np.float32)
BOOLS = _rng(2).random((3, 4, 5)) > 0.3
I8 = _rng(3).integers(-127, 128, (2, 4, 5)).astype(np.int8)

CASES = {
    # QAT fake ops: the fp32 quantize-dequantize round trip
    "fake_quantize_abs_max": ({"X": [X4]}, {"bit_length": 8}),
    "fake_quantize_range_abs_max": (
        {"X": [X4], "InScale": [np.array([1.7], np.float32)]}, {"bit_length": 8}),
    "fake_quantize_moving_average_abs_max": ({"X": [X4]}, {"scale": 2.5, "bit_length": 8}),
    "fake_quantize_dequantize_moving_average_abs_max": (
        {"X": [X4], "InScale": [np.array([-0.9], np.float32)]}, {"bit_length": 8}),
    "fake_quantize_dequantize_abs_max": ({"X": [X3]}, {"bit_length": 4}),
    "fake_dequantize_max_abs": (
        {"X": [X4], "Scales": [np.array([3.0], np.float32)]}, {"max_range": 127.0}),
    "fake_channel_wise_dequantize_max_abs": (
        {"X": [X4], "Scales": [np.abs(_x((3,), 4))]}, {"quant_bits": [8]}),
    # shape ops (views)
    "flatten_contiguous_range": ({"X": [X4]}, {"start_axis": -3, "stop_axis": -1}),
    "flatten": ({"X": [X4]}, {"axis": 2}),
    "flatten2": ({"X": [X4]}, {"axis": 0}),
    "squeeze": ({"X": [_x((2, 1, 5, 1))]}, {"axes": []}),
    "squeeze2": ({"X": [_x((2, 1, 5, 1))]}, {"axes": [-1]}),
    "unsqueeze": ({"X": [X3]}, {"axes": [0, -1]}),
    "unsqueeze2": ({"X": [X3]}, {"axes": [1]}),
    "stack": ({"X": [X3, _x((2, 4, 5), 5), _x((2, 4, 5), 6)]}, {"axis": -2}),
    "assign": ({"X": [X4]}, {}),
    # interp, paddle 2.x name
    "nearest_interp_v2": ({"X": [X4]}, {"out_h": 7, "out_w": 13, "align_corners": False}),
    # unary
    "ceil": ({"X": [HALVES]}, {}),
    "round": ({"X": [HALVES]}, {}),
    "sign": ({"X": [HALVES]}, {}),
    "erf": ({"X": [X4]}, {}),
    "sin": ({"X": [X4 * 4]}, {}),
    "cos": ({"X": [X4 * 4]}, {}),
    # reductions
    "reduce_mean": ({"X": [X4]}, {"dim": [1, -2], "keep_dim": False}),
    "reduce_sum": ({"X": [X4]}, {"dim": [-1], "keep_dim": True}),
    "reduce_max": ({"X": [X4]}, {"dim": [0, 2], "keep_dim": True}),
    "reduce_min": ({"X": [X4]}, {"dim": [-3], "keep_dim": False}),
    "reduce_prod": ({"X": [X3]}, {"dim": [1, 2], "keep_dim": False}),
    "reduce_all": ({"X": [BOOLS]}, {"dim": [-1], "keep_dim": False}),
    "reduce_any": ({"X": [BOOLS]}, {"dim": [0, 1], "keep_dim": True}),
    "arg_max": ({"X": [X4]}, {"axis": -1}),
    # constants
    "fill_constant": ({}, {"shape": [2, 3], "value": 1.5, "dtype": "float32"}),
    "shape": ({"Input": [X4]}, {}),
    # nn
    "dropout": ({"X": [X4]}, {"dropout_prob": 0.3,
                              "dropout_implementation": "downgrade_in_infer"}),
    "prelu": ({"X": [X4], "Alpha": [_x((3,), 7)]}, {"mode": "channel"}),
    # detection
    "density_prior_box": (
        {"Input": [_x((1, 4, 5, 8))], "Image": [_x((1, 32, 40, 3))]},
        {"fixed_sizes": [8.0, 16.0], "fixed_ratios": [1.0], "densities": [2, 1],
         "variances": [0.1, 0.1, 0.2, 0.2], "clip": True, "offset": 0.5}),
    "yolo_box": (
        {"X": [_x((1, 3, 4, 2 * (5 + 3)))], "ImgSize": [np.array([[96, 128]], np.int32)]},
        {"anchors": [10, 13, 16, 30], "class_num": 3, "conf_thresh": 0.4,
         "downsample_ratio": 32, "clip_bbox": True}),
}

OUTS = {
    "reduce_all": (("Out", "BOOL"),), "reduce_any": (("Out", "BOOL"),),
    "arg_max": (("Out", "INT64"),), "shape": (("Out", "INT32"),),
    "stack": (("Y", "FP32"),),
    "density_prior_box": (("Boxes", "FP32"), ("Variances", "FP32")),
    "yolo_box": (("Boxes", "FP32"), ("Scores", "FP32")),
}
INEXACT = {"erf", "sin", "cos", "reduce_mean", "reduce_sum", "reduce_prod", "yolo_box"}


def test_the_cases_cover_every_new_op_name():
    assert set(CASES) | {"bilinear_interp_v2"} == set(NEW_OPS)


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_op_matches_reference(op_type):
    inputs, attrs = CASES[op_type]
    want, got = run_both(op_type, inputs, attrs, OUTS.get(op_type, (("Out", "FP32"),)))
    assert_same(want, got, exact=op_type not in INEXACT)


# ---- edge attrs -----------------------------------------------------------------

@pytest.mark.parametrize("op_type", ["reduce_mean", "reduce_max", "reduce_sum"])
def test_reduce_of_int8_dequantizes(op_type):
    want, got = run_both(op_type, {"X": [I8]}, {"dim": [-1], "keep_dim": False},
                         scales={"x0": 0.05})
    assert_same(want, got, exact=op_type == "reduce_max")


@pytest.mark.parametrize("op_type", ["reduce_mean", "reduce_all", "reduce_prod"])
def test_reduce_all_reduces_every_axis(op_type):
    """fluid's ``reduce_all`` reduces every axis whatever ``dim`` holds; the
    reference reads only ``dim`` (a fault there), so the port is held to the
    reference given every axis in ``dim``."""
    x = BOOLS if op_type == "reduce_all" else X3
    prec = "BOOL" if op_type == "reduce_all" else "FP32"
    full = {"dim": [0, 1, 2], "keep_dim": False}
    want, _ = run_both(op_type, {"X": [x]}, full, (("Out", prec),))
    _, got = run_both(op_type, {"X": [x]}, {"dim": [0], "keep_dim": False,
                                            "reduce_all": True}, (("Out", prec),))
    assert got[0].shape == (1,)
    assert_same(want, got, exact=op_type == "reduce_all")


def test_reduce_without_dim_reduces_every_axis():
    want, got = run_both("reduce_max", {"X": [X4]}, {"keep_dim": True})
    assert want[0].shape == (1, 1, 1, 1)
    assert_same(want, got, exact=True)


def test_arg_max_keepdims_keeps_the_axis():
    """Without ``keepdims`` the reference's result; with it, the same
    indices with the axis kept as 1 (the reference drops it either way)."""
    ties = np.array([[1.0, 3.0, 3.0, 2.0], [np.nan, 1.0, np.nan, 0.0]], np.float32)
    want, got = run_both("arg_max", {"X": [ties]}, {"axis": 1}, (("Out", "INT64"),))
    assert_same(want, got, exact=True)
    np.testing.assert_array_equal(got[0], [1, 0])
    _, kept = run_both("arg_max", {"X": [ties]}, {"axis": 1, "keepdims": True},
                       (("Out", "INT64"),))
    np.testing.assert_array_equal(kept[0], want[0][:, None])


@pytest.mark.parametrize("dtype", ["float32", "int32", "int64", "bool"])
def test_fill_constant_dtypes(dtype):
    prec = {"float32": "FP32", "int32": "INT32", "int64": "INT64", "bool": "BOOL"}[dtype]
    want, got = run_both("fill_constant", {}, {"shape": [3, 1, 2], "value": 3.7,
                                              "dtype": dtype}, (("Out", prec),))
    assert_same(want, got, exact=True)


@pytest.mark.parametrize("mode,alpha", [("all", (1,)), ("element", (5, 6, 3))])
def test_prelu_modes(mode, alpha):
    want, got = run_both("prelu", {"X": [X4], "Alpha": [_x(alpha, 8)]}, {"mode": mode})
    assert_same(want, got, exact=True)


def test_dropout_upscale_in_train_is_the_identity():
    want, got = run_both("dropout", {"X": [X4]}, {
        "dropout_prob": 0.5, "dropout_implementation": "upscale_in_train"})
    assert_same(want, got, exact=True)
    np.testing.assert_array_equal(got[0], X4)


@pytest.mark.parametrize("bits", [8, 5])
def test_fake_quant_scale_from_the_input(bits):
    want, got = run_both("fake_quantize_abs_max", {"X": [X3 * 10]}, {"bit_length": bits})
    assert_same(want, got, exact=True)


def test_interp_v2_scale_form():
    want, got = run_both("nearest_interp_v2", {"X": [X4]}, {"scale": 2.0})
    assert_same(want, got, exact=True)


def test_bilinear_interp_v2_is_bilinear():
    """Deliberately not the reference's ``bilinear_interp_v2``, which
    resizes by nearest (its ``interp_xla`` picks bilinear for the name
    ``bilinear_interp`` only): the port's ``_v2`` equals the port's and the
    reference's ``bilinear_interp``."""
    attrs = {"out_h": 9, "out_w": 11, "align_corners": False}
    ref_bilinear, port_bilinear = run_both("bilinear_interp", {"X": [X4]}, attrs)
    ref_v2, port_v2 = run_both("bilinear_interp_v2", {"X": [X4]}, attrs)
    assert_same(ref_bilinear, port_v2, exact=False)
    np.testing.assert_array_equal(port_v2[0], port_bilinear[0])
    ref_nearest, _ = run_both("nearest_interp", {"X": [X4]}, attrs)
    np.testing.assert_array_equal(ref_v2[0], ref_nearest[0])  # the reference's fault
    assert not np.allclose(port_v2[0], ref_v2[0])


def test_density_prior_box_counts_every_ratio():
    """With several ``fixed_ratios`` the reference's impl makes
    ``len(ratios)`` boxes a density cell but its shape function counts one
    (a fault there); the port's shape function counts what both impls
    make, and the boxes equal the reference impl's."""
    from paddle_lite_tpu.core.executor import ExecutionContext as RContext
    from paddle_lite_tpu.ops.detection import density_prior_box_xla

    attrs = {"fixed_sizes": [8.0, 16.0], "fixed_ratios": [1.0, 2.0, 0.5],
             "densities": [2, 1], "clip": False, "step_w": 8.0, "step_h": 8.0}
    feat, img = _x((1, 4, 5, 8)), _x((1, 32, 40, 3))
    shapes = POPS.get("density_prior_box").infer_shape(attrs, [feat.shape, img.shape])
    g = PGraph("dpb")
    g.add_var("f", feat.shape)
    g.add_var("i", img.shape)
    g.add_var("b", shapes[0])
    g.add_var("v", shapes[1])
    op = g.add_op("density_prior_box", {"Input": ["f"], "Image": ["i"]},
                  {"Boxes": ["b"], "Variances": ["v"]}, attrs)
    ref = density_prior_box_xla(RContext(graph=RGraph("r"), platform="cpu"), op,
                                {"Input": [feat], "Image": [img]})
    ref_boxes = np.asarray(jax.device_get(ref["Boxes"][0]))
    assert shapes[0] == ref_boxes.shape == (4, 5, 15, 4)
    assert ROPS.get("density_prior_box").infer_shape(attrs, [feat.shape, img.shape])[0] \
        != ref_boxes.shape
    g.inputs = ["f", "i"]
    g.outputs = ["b", "v"]
    g.rebuild_links()
    got = P.build_callable(g, device=CPU)({}, {"f": feat, "i": img})
    np.testing.assert_array_equal(got["b"].numpy(), ref_boxes)


@pytest.mark.parametrize("clip", [False, True])
def test_yolo_box_batch_one(clip):
    inputs, attrs = CASES["yolo_box"]
    want, got = run_both("yolo_box", inputs, dict(attrs, clip_bbox=clip),
                         OUTS["yolo_box"])
    assert_same(want, got, exact=False)


def test_yolo_box_clips_each_image_to_its_own_size():
    """At batch > 1 the reference's ``clip_bbox`` broadcasts each image's
    (N, 1, 1) size against the (N, H, W, an) boxes' trailing axes, which
    fails or clips by another image's size (a fault there).  Without clip
    the port equals the reference; with clip each image's boxes lie in
    [0, its size - 1] and equal the unclipped boxes clipped in numpy."""
    x = _x((3, 2, 2, 2 * 7), 9, scale=2.0)
    sizes = np.array([[64, 96], [32, 48], [128, 40]], np.int32)
    attrs = {"anchors": [10, 13, 30, 40], "class_num": 2, "conf_thresh": 0.2,
             "downsample_ratio": 16}
    inputs = {"X": [x], "ImgSize": [sizes]}
    want, raw = run_both("yolo_box", inputs, dict(attrs, clip_bbox=False), OUTS["yolo_box"])
    assert_same(want, raw, exact=False)
    with pytest.raises((TypeError, ValueError)):  # the reference's broadcast
        run_both("yolo_box", inputs, dict(attrs, clip_bbox=True), OUTS["yolo_box"])
    clipped = run_port("yolo_box", inputs, dict(attrs, clip_bbox=True), OUTS["yolo_box"])
    hi = np.stack([sizes[:, 1], sizes[:, 0]] * 2, axis=-1)[:, None, :].astype(np.float32) - 1
    np.testing.assert_array_equal(clipped[0], np.minimum(np.maximum(raw[0], 0), hi))
    np.testing.assert_array_equal(clipped[1], raw[1])


# ---- every op name the converter can emit is registered ---------------------------

def converter_op_names():
    """Every op type ``fluid_convert`` can put in a graph: the names its
    handlers pass to ``_emit`` / ``add_op``, its sets of unary, fake-quant
    and reduce names, and the names of its ``_op_*`` handlers (a handler
    that emits its own type), less feed / fetch (no op) and ``matmul_v2``
    (emitted as ``matmul``)."""
    src = inspect.getsource(fluid_convert)
    names = set(re.findall(r'_emit\("(\w+)"', src)) | set(re.findall(r'add_op\("(\w+)"', src))
    names |= (fluid_convert._UNARY_ACTS | fluid_convert._UNARY_PLUMBING
              | fluid_convert._FAKE_QUANT_OPS | fluid_convert._REDUCES)
    names |= {n[4:] for n in dir(fluid_convert.FluidConverter) if n.startswith("_op_")}
    return sorted(names - {"feed", "fetch", "matmul_v2"})


NEW_OPS = [
    "arg_max", "assign", "bilinear_interp_v2", "ceil", "cos", "density_prior_box",
    "dropout", "erf", "fake_channel_wise_dequantize_max_abs", "fake_dequantize_max_abs",
    "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_quantize_moving_average_abs_max", "fake_quantize_range_abs_max",
    "fill_constant", "flatten", "flatten2", "flatten_contiguous_range",
    "nearest_interp_v2", "prelu", "reduce_all", "reduce_any", "reduce_max",
    "reduce_mean", "reduce_min", "reduce_prod", "reduce_sum", "round", "shape", "sign",
    "sin", "squeeze", "squeeze2", "stack", "unsqueeze", "unsqueeze2", "yolo_box",
]


def test_this_slice_adds_38_names_to_115():
    assert len(NEW_OPS) == 38
    assert set(NEW_OPS) <= set(converter_op_names())
    assert len(POPS.names()) == len(ROPS.names())
    assert set(POPS.names()) <= set(ROPS.names())


@pytest.mark.parametrize("op_type", converter_op_names())
def test_converter_op_name_is_registered(op_type):
    assert op_type in POPS
    opdef = POPS.get(op_type)
    assert opdef.infer_shape is not None and "torch" in opdef.impls


@pytest.mark.parametrize("op_type", [n for n in NEW_OPS if n.startswith("fake_")])
def test_fake_ops_keep_the_reference_input_slots(op_type):
    assert tuple(POPS.get(op_type).input_slots) == tuple(ROPS.get(op_type).input_slots)
