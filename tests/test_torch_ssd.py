"""SSD-MobileNetV1 INT8 — the second slice's path — through both packages.

160 px, batch 2, 5 classes: M = 640 priors, so the default bucket3@176
candidate tier runs (4 priors a bucket; the last 16 buckets are padding).
Inputs are made with numpy from a seed and handed to both packages.

Tolerances, and why:
- activation scales: rtol 1e-5 (abs-maxes of fp32 activations whose sums
  run in another order in XLA and in torch); weights and weight scales
  exact.
- the reference's optimized graph run by both packages: int8 tensors at
  most 1% of elements off, by at most 3 LSB (the bound of
  tests/test_torch_main_path.py: the fp32 stem conv's sums may round to
  the other side of a requant tie on another CPU; measured equal here);
  softmax scores within ``testing.SOFTMAX_ATOL``; decoded boxes within
  1e-5 (normalized coordinates; exp and FMA ulps, measured ≤ 1e-6).
- ``multiclass_nms`` fed the JAX op's captured inputs: exact.
"""

import copy

import numpy as np
import pytest
import torch

import jax

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.executor import ExecutionContext as RContext
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.models import ssd as r_ssd
from paddle_lite_tpu.ops import detection as r_det
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import ssd as p_ssd
from paddle_lite_tpu_torch.ops.kernels import depthwise, int8_matmul, nms
from paddle_lite_tpu_torch.runtime.predictor import Predictor
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
KW = dict(batch=2, image_size=160, num_classes=5, seed=0)
SHAPE = (2, 160, 160, 3)
SCALE_RTOL = 1e-5
INT8_FRACTION, INT8_LSB = 1e-2, 3
BOX_ATOL = 1e-5
# int8 graph: 33 convs on the GEMM (17 pointwise, 16 3x3 through im2col),
# 13 depthwise, 1 NMS
N_CUDA = 33 + 13 + 1


def _feed(seed):
    return {"image": np.random.default_rng(seed).normal(size=SHAPE)
            .astype(np.float32)}


@pytest.fixture(scope="module")
def pair():
    calib = [_feed(1)]
    gr = r_ssd.build(**KW)
    r_optimize(gr, quant=R.QuantConfig(), calib_batches=calib)
    gp = p_ssd.build(**KW)
    optimize(gp, quant=P.QuantConfig(), calib_batches=calib, device="cpu")
    return gr, gp


def _nms_op(g):
    return next(o for o in g.ops if o.op_type == "multiclass_nms")


def test_optimize_matches_reference(pair):
    gr, gp = pair
    assert [o.op_type for o in gr.ops] == [o.op_type for o in gp.ops]
    for a, b in zip(gr.ops, gp.ops):
        assert a.inputs == b.inputs and a.outputs == b.outputs
        ka = {k: v for k, v in a.attrs.items() if k not in ("kernel", "out_scale")}
        kb = {k: v for k, v in b.attrs.items() if k not in ("kernel", "out_scale")}
        assert ka == kb, a.op_type
        assert ("out_scale" in a.attrs) == ("out_scale" in b.attrs)
        if "out_scale" in a.attrs:
            np.testing.assert_allclose(b.attrs["out_scale"], a.attrs["out_scale"],
                                       rtol=SCALE_RTOL)
    for n, v in gr.vars.items():
        w = gp.vars[n]
        assert v.precision.value == w.precision.value and v.shape == w.shape, n
        if v.quant is not None:
            np.testing.assert_allclose(w.quant.scale, v.quant.scale,
                                       rtol=0 if v.is_weight else SCALE_RTOL)
    for n, a in gr.weights.items():
        assert np.array_equal(np.asarray(a), gp.weights[n]), n
    tags = {}
    for o in gp.ops:
        if o.attrs.get("kernel") == "cuda":
            tags[o.op_type] = tags.get(o.op_type, 0) + 1
    assert tags == {"conv2d": 33, "depthwise_conv2d": 13, "multiclass_nms": 1}
    assert sum(tags.values()) == N_CUDA
    assert all(o.attrs.get("kernel") in (None, "cuda") for o in gp.ops)
    # the int8 3x3 convs (4 extra stages, 12 heads) run on the GEMM too: no
    # int8 conv is left on the torch path
    n_3x3 = sum(1 for o in gp.ops if o.op_type == "conv2d"
                and o.attrs.get("enable_int8") and o.attrs.get("kernel") is None)
    assert n_3x3 == 0


def test_fp32_graph_runs_nms_on_the_kernel():
    g = p_ssd.build(**KW)
    optimize(g, device="cpu")
    assert [o.op_type for o in g.ops if o.attrs.get("kernel") == "cuda"] == [
        "multiclass_nms"]


def test_interop_carries_ssd_attrs(pair):
    gr, _ = pair
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    for a, b in zip(gr.ops, gp.ops):
        for k, v in a.attrs.items():
            if k == "kernel":
                continue
            assert b.attrs[k] == v and type(b.attrs[k]) is type(v), (a.op_type, k)
    nms_attrs = _nms_op(gp).attrs
    assert nms_attrs["approx_top_k"] == "bucket3"
    assert nms_attrs["bucket_candidates"] == 176
    assert nms_attrs["kernel"] == "cuda"
    prior = next(o for o in gp.ops if o.op_type == "prior_box").attrs
    assert prior["flip"] is True and prior["clip"] is True
    assert prior["variances"] == [0.1, 0.1, 0.2, 0.2]
    assert all(isinstance(v, float) for v in prior["min_sizes"] + prior["aspect_ratios"])


def _ref_capture(graph, feed):
    env = {}
    fn = R.build_callable(graph, platform="cpu",
                          capture=lambda n, v: env.__setitem__(n, v))
    fn(R.stage_weights(graph), feed)
    return {k: np.asarray(jax.device_get(v)) for k, v in env.items()}


@pytest.mark.parametrize("nms_tag", ["pallas", "xla"])
def test_reference_graph_end_to_end(pair, nms_tag):
    """The reference's optimized graph through both packages: convs on
    XLA vs the port's torch ops, NMS on the Pallas kernel (interpret mode)
    vs the port's "cuda" impl (plain version on the CPU), or XLA vs torch."""
    gr = copy.deepcopy(pair[0])
    _nms_op(gr).attrs["kernel"] = nms_tag
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    assert _nms_op(gp).attrs["kernel"] == {"pallas": "cuda", "xla": "torch"}[nms_tag]
    feed = _feed(2)
    ref = _ref_capture(gr, feed)
    got = testing.capture_all(gp, P.stage_weights(gp, CPU), feed, CPU)
    n_int8 = 0
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if r.dtype == np.int8:
            n_int8 += 1
            d = np.abs(g.astype(np.int32) - r.astype(np.int32))
            assert d.max() <= INT8_LSB and (d > 0).mean() <= INT8_FRACTION, name
    assert n_int8 >= 30
    nms_r = _nms_op(gr)
    boxes, scores = nms_r.inputs["BBoxes"][0], nms_r.inputs["Scores"][0]
    np.testing.assert_allclose(got[scores].numpy(), ref[scores], rtol=0,
                               atol=testing.SOFTMAX_ATOL)
    np.testing.assert_allclose(got[boxes].numpy(), ref[boxes], rtol=0,
                               atol=BOX_ATOL)
    # the NMS op fed the JAX op's captured inputs: exact, also when fewer
    # than keep_top_k detections survive
    nms_p = _nms_op(gp)
    r_impl = {"pallas": r_det.multiclass_nms_pallas,
              "xla": r_det.multiclass_nms_xla}[nms_tag]
    p_impl = OPS.get("multiclass_nms").impls[nms_p.attrs["kernel"]]
    ins_r = {"BBoxes": [ref[boxes]], "Scores": [ref[scores]]}
    ins_p = {"BBoxes": [torch.tensor(ref[boxes])],
             "Scores": [torch.tensor(ref[scores])]}
    out = nms_r.outputs["Out"][0]
    assert np.array_equal(p_impl(None, nms_p, ins_p)["Out"][0].numpy(), ref[out])
    for op in (nms_r, nms_p):
        op.attrs["score_threshold"] = 0.45
    ctx = RContext(graph=gr, platform="cpu", interpret=True)
    want = np.asarray(r_impl(ctx, nms_r, ins_r)["Out"][0])
    n_valid = (want[..., 0] >= 0).sum(axis=1)
    assert (n_valid < 100).all() and (n_valid > 0).all(), n_valid
    assert np.array_equal(p_impl(None, nms_p, ins_p)["Out"][0].numpy(), want)


def test_predictor_serves_ssd_on_cpu(pair):
    _, gp = pair
    pred = Predictor(gp, device="cpu")
    int8_matmul.launches = depthwise.launches = nms.launches = 0
    out = pred.run(_feed(3))[gp.outputs[0]]
    assert (int8_matmul.launches, depthwise.launches, nms.launches) == (0, 0, 0)
    assert out.shape == (2, 100, 6) and bool(torch.isfinite(out).all())
    labels = out[..., 0]
    assert bool(((labels >= 1) & (labels < 5) | (labels == -1)).all())
    valid = labels >= 0
    assert bool((out[..., 1][valid] > 0.01).all())
    # rows are score-descending within each image
    assert bool((out[:, 1:, 1] <= out[:, :-1, 1]).all())


def test_cuda_tags_vs_torch_tags(pair):
    """Every kernel op but the NMS (``testing.OTHER_FUNCTION``) against its
    torch op on the inputs the kernel run gave it: within rounding ties."""
    _, gp = pair
    w = P.stage_weights(gp, CPU)
    diffs = testing.op_local_diffs(gp, w, _feed(4), CPU)
    assert len(diffs) == N_CUDA - 1 and testing.within_tie_bound(diffs)
    assert {d["op"] for d in diffs} == {"conv2d", "depthwise_conv2d"}
