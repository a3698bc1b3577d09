"""The main path — MobileNetV1 INT8 PTQ — through both packages.

Small sizes (width 0.25-0.5, batch 2, 32-64 px) keep each test to seconds.
Inputs are made with numpy from a seed and handed to both packages.

Tolerances, and why:
- activation scales: rtol 1e-5.  They are abs-maxes of fp32 activations;
  the fp32 conv sums run in another order in XLA and in torch.
- int8 weights and weight scales: exact (the same numpy code).
- int8 intermediates of the same optimized graph in both packages: equal
  here, but the fp32 stem conv's sums run in another order, so on another
  CPU its requantized output may flip at a rounding tie, and a flip moves
  the layers after it: at most 1% of the elements of any int8 tensor may
  differ, by at most 3 LSB.
- softmax output: atol 1e-3, the bound chip_smoke.py holds the card to
  (measured equal here).
"""

import numpy as np
import pytest
import torch

import jax

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.models import mobilenet_v1 as r_mnv1
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import mobilenet_v1 as p_mnv1
from paddle_lite_tpu_torch.ops.kernels import depthwise, int8_matmul
from paddle_lite_tpu_torch.runtime.predictor import (Predictor,
                                                     PredictorConfig,
                                                     create_predictor)
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
KW = dict(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0)
SCALE_RTOL = 1e-5
INT8_FRACTION, INT8_LSB = 1e-2, 3
SOFTMAX_ATOL = testing.SOFTMAX_ATOL


def _feeds(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=shape).astype(np.float32)} for _ in range(n)]


def _optimized_pair(kw=KW):
    shape = (kw["batch"], kw["image_size"], kw["image_size"], 3)
    calib = _feeds(shape, 2, seed=1)
    gr = r_mnv1.build(**kw)
    r_optimize(gr, quant=R.QuantConfig(), calib_batches=calib)
    gp = p_mnv1.build(**kw)
    optimize(gp, quant=P.QuantConfig(), calib_batches=calib, device="cpu")
    return gr, gp


def _ref_capture(graph, feed):
    env = {}
    fn = R.build_callable(graph, platform="cpu",
                          capture=lambda n, v: env.__setitem__(n, v))
    fn(R.stage_weights(graph), feed)
    return {k: np.asarray(jax.device_get(v)) for k, v in env.items()}


def _compare_captures(ref, got, out_name):
    n_int8 = 0
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if r.dtype == np.int8:
            n_int8 += 1
            d = np.abs(g.astype(np.int32) - r.astype(np.int32))
            assert d.max() <= INT8_LSB and (d > 0).mean() <= INT8_FRACTION, name
    np.testing.assert_allclose(got[out_name].numpy(), ref[out_name],
                               rtol=0, atol=SOFTMAX_ATOL)
    return n_int8


@pytest.mark.parametrize("kw", [KW, dict(KW, width_mult=0.5, image_size=64, seed=4)])
def test_optimize_matches_reference(kw):
    gr, gp = _optimized_pair(kw)
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
    # the port tags every int8 op a kernel takes: 13 pw + 13 dw + fc
    assert sum(o.attrs.get("kernel") == "cuda" for o in gp.ops) == 27
    assert all(o.attrs.get("kernel") in (None, "cuda") for o in gp.ops)


@pytest.mark.parametrize("ref_tag", ["pallas", "xla"])
def test_reference_graph_end_to_end(ref_tag):
    """(a) JAX with Pallas kernels (interpret mode) vs the port's "cuda"
    tags (plain versions on the CPU); (b) JAX "xla" vs the port's "torch"."""
    gr, _ = _optimized_pair()
    for op in gr.ops:
        if op.attrs.get("kernel") in ("xla", "pallas"):
            op.attrs["kernel"] = ref_tag
    assert sum(o.attrs.get("kernel") == ref_tag for o in gr.ops) == 27
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    want = {"pallas": "cuda", "xla": "torch"}[ref_tag]
    assert sum(o.attrs.get("kernel") == want for o in gp.ops) == 27
    feed = _feeds((2, 32, 32, 3), 1, seed=2)[0]
    ref = _ref_capture(gr, feed)
    got = testing.capture_all(gp, P.stage_weights(gp, CPU), feed, CPU)
    assert _compare_captures(ref, got, gr.outputs[0]) >= 27


def test_cuda_tags_vs_torch_tags():
    """The port's two tags on one graph: each kernel op fed the inputs the
    kernel run gave it matches its torch op up to rounding ties (see
    paddle_lite_tpu_torch/testing.py); the softmax output end to end."""
    _, gp = _optimized_pair(dict(KW, width_mult=1.0, image_size=64, seed=5))
    feed = _feeds((2, 64, 64, 3), 1, seed=3)[0]
    w = P.stage_weights(gp, CPU)
    diffs = testing.op_local_diffs(gp, w, feed, CPU)
    assert len(diffs) == 27 and testing.within_tie_bound(diffs)
    a = testing.capture_all(gp, w, feed, CPU)[gp.outputs[0]]
    b = testing.capture_all(testing.retag(gp, "cuda", "torch"), w, feed,
                            CPU)[gp.outputs[0]]
    assert float((a - b).abs().max()) <= testing.SOFTMAX_ATOL


def test_int8_predictor_agrees_with_fp32():
    """The bar tests/test_quantization.py:114 uses: cosine > 0.99 and top-1
    agreement on most samples, int8 vs the port's own fp32 predictor."""
    kw = dict(batch=4, image_size=64, num_classes=100, seed=7)
    shape = (4, 64, 64, 3)
    feed = _feeds(shape, 1, seed=4)[0]
    ref = create_predictor(p_mnv1.build(**kw), device="cpu").run(feed)
    pred = create_predictor(p_mnv1.build(**kw), quant=P.QuantConfig(),
                            calib_batches=_feeds(shape, 3, seed=5), device="cpu")
    out_name = pred.output_names[0]
    int8_matmul.launches = depthwise.launches = 0
    got = pred.run(feed)[out_name].numpy()
    assert int8_matmul.launches == 0 and depthwise.launches == 0  # CPU: plain
    want = ref[out_name].numpy()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.75
    cos = np.sum(got * want) / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.99, cos


def test_predictor_validation_and_clone():
    g = p_mnv1.build(**KW)
    pred = create_predictor(g, quant=P.QuantConfig(),
                            calib_batches=_feeds((2, 32, 32, 3), 1), device="cpu")
    feed = _feeds((2, 32, 32, 3), 1, seed=9)[0]
    with pytest.raises(ValueError, match="missing input"):
        pred.run({})
    with pytest.raises(ValueError, match="shape"):
        pred.run({"image": np.zeros((1, 32, 32, 3), np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        pred.run(dict(feed, extra=np.zeros(1)))
    out = pred(feed)[g.outputs[0]]
    assert out.shape == (2, 10) and out.dtype == torch.float32
    c = pred.clone(PredictorConfig(validate_inputs=False, device="cpu"))
    assert c._weights is pred._weights
    assert torch.equal(c.run({"image": torch.from_numpy(feed["image"])})[g.outputs[0]], out)
    assert pred.input_shape("image") == (2, 32, 32, 3)


@pytest.mark.parametrize("cfg", [
    dict(weight_only=8), dict(method=P.CalibMethod.ENTROPY), dict(conv1x1_dot=True),
    dict(bias_correction=True), dict(island_dtype="float16"),
    dict(method=P.CalibMethod.PERCENTILE),
])
def test_unported_options_raise(cfg):
    g = p_mnv1.build(**KW)
    with pytest.raises(NotImplementedError):
        optimize(g, quant=P.QuantConfig(**cfg),
                 calib_batches=_feeds((2, 32, 32, 3), 1), device="cpu")


def test_cuda_impl_raises_instead_of_falling_back():
    g = p_mnv1.build(**KW)
    optimize(g, device="cpu")  # fp32: no op is int8
    conv = next(o for o in g.ops if o.op_type == "conv2d"
                and g.vars[o.input("Filter")].shape[:2] == (1, 1))
    conv.attrs["kernel"] = "cuda"
    with pytest.raises(ValueError, match="int8"):
        Predictor(g, device="cpu").run(_feeds((2, 32, 32, 3), 1)[0])
