"""The rest of quantization through both packages: the histogram and
moving-average calibration methods, channel means and bias correction,
weight-only W4 / W8 / W16 storage, and ``conv1x1_dot``.

Small sizes: MobileNetV1 at width 0.25, batch 2, 32 px; ERNIE-tiny at 2
layers, hidden 64 (the size of ``tests/test_torch_ernie.py``).  Inputs are
made with numpy from a seed and handed to both packages.

Tolerances, and why:
- ``unpack_w4``, the histogram edges and counts, ``weight_only_quantize``,
  ``apply_bias_correction`` on identical inputs: exact (the same integer
  and float32 arithmetic; the edges are built by ``jnp.linspace``'s own
  formula).
- calibrated scales: the fp32 convs sum in another order in XLA and in
  torch, so a tensor's abs-max may differ in its last bits (rtol 1e-5),
  and a histogram method's clip point may then move by one bin: each scale
  within rtol 1e-5 plus one bin's width (amax / bins / 127).
- channel means: rtol 1e-5, atol 1e-6 of the largest mean (fp32 sums in
  another order).
- the reference's optimized graph run by the port: every op fed the
  reference's captured inputs; int8 outputs within ``testing.TIE_*`` (the
  requant's ties), fp32 outputs within rtol / atol 1e-5 (fp32 sums in
  another order; the weight-only dequant is the same float32 product);
  the graph's output end to end within 1e-5 for weight-only graphs and
  ``testing.SOFTMAX_ATOL`` for int8 ones.
- ``conv1x1_dot``: the port's conv form with the attr bit-identical to
  the same graph without it; the reference's reshape + int32 dot run op by
  op by the port as the other graphs above (both give the exact int8
  accumulator, so only the requant's ties may differ).
"""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.builder import GraphBuilder as RBuilder
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.models import ernie_tiny as r_ernie
from paddle_lite_tpu.models import mobilenet_v1 as r_mnv1
from paddle_lite_tpu.ops.common import _unpack_w4
from paddle_lite_tpu.quant.bias_correction import apply_bias_correction as r_bias_correction
from paddle_lite_tpu.quant.calibrate import calibrate as r_calibrate
from paddle_lite_tpu.quant.quantize_pass import weight_only_quantize as r_weight_only
from paddle_lite_tpu.tools.opt import FUSION_PASSES as R_FUSION
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core.builder import GraphBuilder
from paddle_lite_tpu_torch.core.executor import ExecutionContext
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import ernie_tiny as p_ernie
from paddle_lite_tpu_torch.models import mobilenet_v1 as p_mnv1
from paddle_lite_tpu_torch.ops.common import unpack_w4
from paddle_lite_tpu_torch.quant.bias_correction import apply_bias_correction
from paddle_lite_tpu_torch.quant.calibrate import calibrate, hist_counts, hist_edges
from paddle_lite_tpu_torch.quant.quantize_pass import weight_only_quantize
from paddle_lite_tpu_torch.tools.opt import FUSION_PASSES, optimize

CPU = torch.device("cpu")
MNV1 = dict(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0)
ERNIE = dict(batch=2, seq_len=16, vocab_size=500, hidden=64, n_layers=2, n_heads=4,
             ffn_dim=128, seed=7)
SCALE_RTOL = 1e-5
MEAN_RTOL = 1e-5
OP_TOL = 1e-5
WEIGHT_ONLY_ATOL = 1e-5
WEIGHT_SLOT = {"conv2d": "Filter", "depthwise_conv2d": "Filter", "fc": "W"}


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32)} for _ in range(n)]


def _tokens(seed):
    rng = np.random.default_rng(seed)
    return {"token_ids": rng.integers(0, ERNIE["vocab_size"], (2, 16)).astype(np.int32),
            "segment_ids": rng.integers(0, 4, (2, 16)).astype(np.int32)}


def _cfgs(**kw):
    """The same QuantConfig in each package (the method by its value)."""
    rk = dict(kw)
    pk = {k: (P.CalibMethod(v.value) if k == "method" else v) for k, v in kw.items()}
    return R.QuantConfig(**rk), P.QuantConfig(**pk)


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


def _fused_pair(model="mnv1"):
    """One graph a package after the fusion passes, as calibrate sees it."""
    if model == "mnv1":
        gr, gp = r_mnv1.build(**MNV1), p_mnv1.build(**MNV1)
    else:
        gr, gp = r_ernie.build(**ERNIE), p_ernie.build(**ERNIE)
    R.PassManager(R_FUSION).run(gr)
    P.PassManager(FUSION_PASSES).run(gp)
    return gr, gp


# ---- W4 unpacking, histogram edges and counts --------------------------------------

@pytest.mark.parametrize("pack_axis", [0, 1, 2])
def test_unpack_w4_every_byte(pack_axis):
    v = np.arange(-128, 128, dtype=np.int16).astype(np.int8).reshape(4, 8, 8)
    want = np.asarray(_unpack_w4(jnp.asarray(v), pack_axis))
    got = unpack_w4(torch.from_numpy(v), pack_axis).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert set(np.unique(got)) == set(range(-8, 8))


def test_histogram_edges_are_jnp_linspace_bit_for_bit():
    rng = np.random.default_rng(0)
    amaxes = np.concatenate([10.0 ** rng.uniform(-12, 6, 300), rng.uniform(0, 10, 200),
                             [0.0, 1e-10, 1e-11, 1.0, 3.0, 6.0, 127.0, 1e30,
                              float(np.float32(0.1)), 0.1, 2.0 ** -20]])
    linspace = jax.jit(lambda a, bins: jnp.linspace(0.0, a, bins + 1), static_argnums=1)
    for bins in (2048, 7, 100, 1000):
        for a in amaxes:
            want = np.asarray(jnp.linspace(0.0, max(float(a), 1e-10), bins + 1))
            got = hist_edges(float(a), bins)
            assert got.dtype == np.float32 and np.array_equal(got.view(np.int32),
                                                              want.view(np.int32)), (a, bins)
        # under jit, as the reference calls it (its amax is a traced constant there)
        for a in amaxes[:50]:
            jitted = np.asarray(linspace(np.float32(max(float(a), 1e-10)), bins))
            assert np.array_equal(hist_edges(float(a), bins), jitted), (a, bins)


@pytest.mark.parametrize("amax,bins", [(3.0, 2048), (1.7, 16), (1e-12, 8), (0.1, 2048)])
def test_histogram_counts_are_jnp_histogram(amax, bins):
    """Values on edges, equal to amax, zero, and random, in one tensor."""
    rng = np.random.default_rng(1)
    edges = hist_edges(amax, bins)
    vals = np.concatenate([edges, edges, np.zeros(5, np.float32),
                           np.float32(amax) * rng.uniform(0, 1, 20000).astype(np.float32),
                           np.nextafter(edges, np.float32(0)),
                           np.nextafter(edges, np.float32(np.inf))]).astype(np.float32)
    vals = np.abs(vals)
    # the reference's pass: edges by jnp.linspace inside jit, jnp.histogram
    ref = jax.jit(lambda v: jnp.histogram(
        v, bins=jnp.linspace(0.0, max(amax, 1e-10), bins + 1))[0])(vals)
    got = hist_counts(torch.from_numpy(vals), torch.from_numpy(edges))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    assert int(got[-1]) >= 2  # amax itself, twice, lands in the last bin


# ---- weight-only storage ------------------------------------------------------------

@pytest.mark.parametrize("model", ["mnv1", "ernie"])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_weight_only_quantize_matches_reference(model, bits):
    gr, gp = _fused_pair(model)
    assert r_weight_only(gr, bits=bits) == weight_only_quantize(gp, bits=bits) > 0
    assert set(gr.weights) == set(gp.weights)
    for n, a in gr.weights.items():
        a = np.asarray(a)
        assert a.dtype == gp.weights[n].dtype and np.array_equal(a, gp.weights[n]), n
    for n, v in gr.vars.items():
        w = gp.vars[n]
        assert v.precision.value == w.precision.value, n
        if v.quant is None:
            assert w.quant is None, n
            continue
        assert (w.quant.scale, w.quant.axis, w.quant.bits, w.quant.pack_axis) == (
            v.quant.scale, v.quant.axis, v.quant.bits, v.quant.pack_axis), n
    if bits == 4 and model == "mnv1":
        # the RGB stem and the HW1O 3x3 depthwise filters have no even
        # axis to pack along: int8 storage for those
        fallback = {gp.vars[n].quant.bits for n in gp.weights
                    if gp.vars[n].quant is not None and gp.weights[n].shape[:3] in
                    ((3, 3, 3), (3, 3, 1))}
        assert fallback == {8}


@pytest.fixture(scope="module", params=[("mnv1", 4), ("mnv1", 8), ("mnv1", 16),
                                        ("ernie", 4), ("ernie", 8), ("ernie", 16)],
                ids=lambda p: f"{p[0]}-w{p[1]}")
def weight_only_pair(request):
    model, bits = request.param
    if model == "mnv1":
        gr, gp = r_mnv1.build(**MNV1), p_mnv1.build(**MNV1)
    else:
        gr, gp = r_ernie.build(**ERNIE), p_ernie.build(**ERNIE)
    rq, pq = _cfgs(weight_only=bits)
    r_optimize(gr, quant=rq)
    optimize(gp, quant=pq, device="cpu")
    feed = _images(1, 3)[0] if model == "mnv1" else _tokens(3)
    return model, bits, gr, gp, feed


def test_weight_only_optimize_matches_reference(weight_only_pair):
    """The same graph as the reference's; no op is int8 or on a kernel (the
    weight-only ops stay on the "torch" route, so the card launches no GEMM
    and no depthwise kernel for them); the weights are stored narrow."""
    model, bits, gr, gp, _ = weight_only_pair
    assert [(o.op_type, o.inputs, o.outputs) for o in gr.ops] == [
        (o.op_type, o.inputs, o.outputs) for o in gp.ops]
    assert not any(o.attrs.get("enable_int8") or o.attrs.get("kernel") for o in gp.ops)
    for n, a in gr.weights.items():
        assert np.array_equal(np.asarray(a), gp.weights[n]), n
    want = {4: np.int8, 8: np.int8, 16: np.int16}[bits]
    names = [o.input(WEIGHT_SLOT[o.op_type]) for o in gp.ops if o.op_type in WEIGHT_SLOT]
    assert {gp.weights[n].dtype for n in names} == {np.dtype(want)}
    staged = P.stage_weights(gp, CPU)
    assert {staged[n].dtype for n in names} == {
        {np.int8: torch.int8, np.int16: torch.int16}[want]}
    if bits == 4:
        fcs = [o.input("W") for o in gp.ops if o.op_type == "fc"]
        assert all(gp.vars[n].quant.pack_axis == 0 for n in fcs)
        assert all(gp.weights[n].size * 2 == np.prod(gp.vars[n].shape) for n in fcs)


def _ref_capture(graph, feed):
    env = {}
    fn = R.build_callable(graph, platform="cpu", capture=lambda n, v: env.__setitem__(n, v))
    out = fn(R.stage_weights(graph), feed)
    return env, {k: np.asarray(jax.device_get(v)) for k, v in out.items()}


def _op_by_op(gr, feed):
    """Every op of the reference's optimized graph run by the port on the
    reference's captured inputs, against the reference's outputs; then the
    carried graph end to end.  Returns (int8 outputs compared, the port's
    graph output, the reference's)."""
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    env, ref_out = _ref_capture(gr, feed)
    w = P.stage_weights(gp, CPU)
    ctx = ExecutionContext(graph=gp, device=CPU)
    n_int8 = 0
    for op in gp.topological_order():
        ins = {s: [torch.from_numpy(np.array(env[n])) if n in env else w[n] for n in ns]
               for s, ns in op.inputs.items() if ns}
        outs = OPS.get(op.op_type).impl_for(op.attrs.get("kernel"))(ctx, op, ins)
        for slot, arrs in outs.items():
            for n, a in zip(op.outputs[slot], arrs):
                r = torch.from_numpy(np.array(env[n]))
                assert a.dtype == r.dtype and a.shape == r.shape, (op.op_type, n)
                if a.dtype == torch.int8:
                    n_int8 += 1
                    d = (a.int() - r.int()).abs()
                    diff = {"numel": d.numel(), "n_diff": int((d > 0).sum()),
                            "max_diff": float(d.max())}
                    assert testing.within_tie_bound([diff]), (op.op_type, n, diff)
                elif a.dtype == torch.float32:
                    torch.testing.assert_close(a, r, rtol=OP_TOL, atol=OP_TOL)
                else:
                    assert torch.equal(a, r), (op.op_type, n)
    k = gr.outputs[0]
    got = P.build_callable(gp, device=CPU)(w, feed)[k].numpy()
    return n_int8, got, ref_out[k]


def test_weight_only_graph_runs_as_the_reference(weight_only_pair):
    _, _, gr, _, feed = weight_only_pair
    n_int8, got, want = _op_by_op(gr, feed)
    assert n_int8 == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=WEIGHT_ONLY_ATOL)


def test_weight_only_w4_fc_dequantized_in_stored_layout():
    """An fc's (K, O) weight packed along K: the port's op against the
    dequantized product, and the wide weight is not kept between runs."""
    b = GraphBuilder("wo", seed=3)
    x = b.input("x", (4, 6))
    b.mark_output(b.fc(x, 5))
    g = b.build()
    optimize(g, quant=P.QuantConfig(weight_only=4), device="cpu")
    (op,) = [o for o in g.ops if o.op_type == "fc"]
    q = g.vars[op.input("W")].quant
    assert (q.bits, q.pack_axis, q.axis) == (4, 0, 1) and g.weights[op.input("W")].shape == (3, 5)
    xs = np.random.default_rng(4).normal(size=(4, 6)).astype(np.float32)
    run = P.build_callable(g, device=CPU)
    w = P.stage_weights(g, CPU)
    got = run(w, {"x": xs})[g.outputs[0]].numpy()
    wq = unpack_w4(torch.from_numpy(g.weights[op.input("W")]), 0).numpy()
    want = xs @ (wq.astype(np.float32) * np.asarray(q.scale, np.float32)) + g.weights[op.input("Bias")]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ctx = ExecutionContext(graph=g, device=CPU)
    OPS.get("fc").impls["torch"](ctx, op, {"Input": [torch.from_numpy(xs)],
                                           "W": [w[op.input("W")]],
                                           "Bias": [w[op.input("Bias")]]})
    kept = [v for v in ctx.consts.values() if isinstance(v, torch.Tensor)]
    assert all(t.numel() <= 5 for t in kept)  # the scale, never a (6, 5) weight


# ---- calibration methods, channel means, bias correction ---------------------------

@pytest.fixture(scope="module")
def calib_pair():
    (gr, gp), batches = _fused_pair("mnv1"), _images(3, 1)
    return (gr, gp), batches, r_calibrate(gr, batches, R.CalibMethod.ABS_MAX).scales


@pytest.mark.parametrize("method", ["percentile", "entropy", "moving_average_abs_max",
                                    "abs_max"])
def test_calibrate_methods_match_reference(calib_pair, method):
    (gr, gp), batches, absmax_scale = calib_pair
    want = r_calibrate(gr, batches, R.CalibMethod(method))
    got = calibrate(gp, batches, P.CalibMethod(method), device=CPU)
    assert set(got.scales) == set(want.scales) and len(want.scales) > 20
    for n, s in want.scales.items():
        # one of 2048 bins over [0, amax], in scale units (amax / 127)
        one_bin = absmax_scale[n] / 2048 if method in ("percentile", "entropy") else 0.0
        assert abs(got.scales[n] - s) <= SCALE_RTOL * s + one_bin * (1 + SCALE_RTOL), (n, method)


def test_channel_means_match_reference(calib_pair):
    (gr, gp), batches, _ = calib_pair
    want = r_calibrate(gr, batches, collect_channel_means=True).channel_means
    got = calibrate(gp, batches, device=CPU, collect_channel_means=True).channel_means
    assert set(got) == set(want) and len(want) > 20
    for n, m in want.items():
        assert got[n].dtype == np.float32 and got[n].shape == m.shape, n
        np.testing.assert_allclose(got[n], m, rtol=MEAN_RTOL,
                                   atol=1e-6 * float(np.abs(m).max()), err_msg=n)


def test_histogram_observers_take_the_bins_asked_for(calib_pair):
    """The reference's observers keep 2048 bins whatever ``bins`` says and
    fail at the first histogram of another size; the port's take it."""
    (gr, gp), batches, _ = calib_pair
    with pytest.raises(ValueError):
        r_calibrate(gr, batches[:1], R.CalibMethod.PERCENTILE, bins=512)
    got = calibrate(gp, batches[:1], P.CalibMethod.PERCENTILE, device=CPU, bins=512)
    assert all(s > 0 for s in got.scales.values())


def _bias_model(seed):
    b = RBuilder("bc", seed=seed)
    x = b.input("x", (4, 8, 8, 16))
    y = b.conv_bn_act(x, 32, 3, padding=1, act="relu")
    y = b.conv_bn_act(y, 32, 3, padding=1, depthwise=True, act="relu")
    y = b.conv2d(y, 24, 1)  # no bias: the correction adds one
    y = b.pool2d(y, "avg", global_pooling=True)
    y = b.reshape(y, (4, 24))
    b.mark_output(b.fc(y, 10))
    return b.build()


def test_apply_bias_correction_matches_reference():
    """Identical quantized graph, fp32 snapshot and channel means: identical
    biases (the created one included) and count."""
    rng = np.random.default_rng(5)
    gr = _bias_model(91)
    offsets = rng.uniform(-1.5, 1.5, size=16).astype(np.float32)
    calib = [{"x": (rng.normal(size=(4, 8, 8, 16)) * 0.5 + offsets).astype(np.float32)}
             for _ in range(2)]
    r_optimize(gr, quant=R.QuantConfig(per_channel_weights=False), calib_batches=calib)
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    snap = {n: (np.asarray(w).astype(np.float32) + rng.normal(size=np.shape(w)).astype(
        np.float32) * 1e-3) for n, w in gr.weights.items() if np.asarray(w).dtype == np.int8}
    means = {n: rng.normal(size=v.shape[-1]).astype(np.float32)
             for n, v in gr.vars.items() if not v.is_weight and len(v.shape) >= 2}
    gr2 = copy.deepcopy(gr)
    n_r = r_bias_correction(gr2, snap, means)
    n_p = apply_bias_correction(gp, snap, means)
    assert n_r == n_p >= 4
    for a, b in zip(gr2.ops, gp.ops):
        if a.maybe_input("Bias"):
            assert b.maybe_input("Bias")
            wa, wb = np.asarray(gr2.weights[a.input("Bias")]), gp.weights[b.input("Bias")]
            assert wa.dtype == wb.dtype == np.float32 and np.array_equal(wa, wb), a.op_type


@pytest.fixture(scope="module", params=["percentile", "entropy", "moving_average_abs_max",
                                        "bias_correction"])
def ptq_pair(request):
    cfg = ({"bias_correction": True, "per_channel_weights": False}
           if request.param == "bias_correction" else {"method": R.CalibMethod(request.param)})
    rq, pq = _cfgs(**cfg)
    calib = _images(2, 1)
    gr, gp = r_mnv1.build(**MNV1), p_mnv1.build(**MNV1)
    _quiet(r_optimize, gr, quant=rq, calib_batches=calib)
    _quiet(optimize, gp, quant=pq, calib_batches=calib, device="cpu")
    return request.param, gr, gp


def test_ptq_graph_matches_reference(ptq_pair):
    """The same ops, attrs and weights as the reference's; activation scales
    within the calibration tolerance; biases (bias correction) within rtol
    1e-5 (they are sums over channel means that differ in their last bits)."""
    name, gr, gp = ptq_pair
    assert [(o.op_type, o.inputs, o.outputs) for o in gr.ops] == [
        (o.op_type, o.inputs, o.outputs) for o in gp.ops]
    for a, b in zip(gr.ops, gp.ops):
        ka = {k: v for k, v in a.attrs.items() if k not in ("kernel", "out_scale")}
        kb = {k: v for k, v in b.attrs.items() if k not in ("kernel", "out_scale")}
        assert ka == kb, a.op_type
    for n, a in gr.weights.items():
        a = np.asarray(a)
        if a.dtype == np.int8 or name != "bias_correction":
            assert np.array_equal(a, gp.weights[n]), n
        else:
            np.testing.assert_allclose(gp.weights[n], a, rtol=SCALE_RTOL, atol=1e-7, err_msg=n)
    assert sum(o.attrs.get("kernel") == "cuda" for o in gp.ops) == 27


def test_ptq_graph_runs_as_the_reference(ptq_pair):
    _, gr, _ = ptq_pair
    n_int8, got, want = _op_by_op(gr, _images(1, 3)[0])
    assert n_int8 >= 27
    np.testing.assert_allclose(got, want, rtol=0, atol=testing.SOFTMAX_ATOL)


def test_entropy_warns():
    """The reference's warning, before any calibration runs."""
    g = p_mnv1.build(**MNV1)
    result = calibrate(g, _images(1, 1), device=CPU)  # abs-max: no KL search
    with pytest.warns(UserWarning, match="ENTROPY"):
        optimize(g, quant=P.QuantConfig(method=P.CalibMethod.ENTROPY),
                 calib_result=result, device="cpu")


# ---- conv1x1_dot ----------------------------------------------------------------------

def _pw_graph(channels, padding, builder=GraphBuilder):
    b = builder("pw", seed=2)
    x = b.input("x", (2, 5, 5, channels))
    y = b.conv2d(x, 16, 1, padding=padding, bias=True)
    b.mark_output(b.conv2d(y, 8, 1))
    return b.build()


@pytest.mark.parametrize("channels", [24, 1280])
def test_conv1x1_dot_is_bit_identical_to_the_conv_form(channels):
    """K = 24 and K = 1280 (> 1040: the conv form sums chunks in int32).
    The port stamps the attr on both convs and runs them in its one conv
    form: every tensor equal to the graph without the attr.  The
    reference's graph with the attr (its reshape + int32 dot) run op by op
    by the port: the same tensors as its dot form."""
    rng = np.random.default_rng(6)
    calib = [{"x": rng.normal(size=(2, 5, 5, channels)).astype(np.float32)}]
    g_dot, g_conv = _pw_graph(channels, 0), _pw_graph(channels, 0)
    optimize(g_dot, quant=P.QuantConfig(conv1x1_dot=True), calib_batches=calib, device="cpu")
    optimize(g_conv, quant=P.QuantConfig(), calib_batches=calib, device="cpu")
    convs = [o for o in g_dot.ops if o.op_type == "conv2d"]
    assert len(convs) == 2 and all(o.attrs.get("conv1x1_dot") for o in convs)
    feed = {"x": rng.normal(size=(2, 5, 5, channels)).astype(np.float32) * 3}
    for g in (g_dot, g_conv):  # the "torch" route
        for o in g.ops:
            o.attrs.pop("kernel", None)
    a = testing.capture_all(g_dot, P.stage_weights(g_dot, CPU), feed, CPU)
    b = testing.capture_all(g_conv, P.stage_weights(g_conv, CPU), feed, CPU)
    assert set(a) == set(b)
    for n in a:
        assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n
    gr = _pw_graph(channels, 0, RBuilder)
    r_optimize(gr, quant=R.QuantConfig(conv1x1_dot=True), calib_batches=calib)
    assert sum(bool(o.attrs.get("conv1x1_dot")) for o in gr.ops) == 2
    n_int8, got, want = _op_by_op(gr, feed)
    assert n_int8 == 2 and got.shape == want.shape == (2, 5, 5, 8)  # quantize, conv


def test_padded_1x1_conv_keeps_the_conv_form():
    """The reference stamps ``conv1x1_dot`` on a padded 1x1 conv (its gate
    has no paddings check) and its dot form would drop the padding; the
    port stamps it on the unpadded conv only, and its conv form keeps the
    padding whatever the attr."""
    rng = np.random.default_rng(7)
    calib = [{"x": rng.normal(size=(2, 5, 5, 24)).astype(np.float32)}]
    b = RBuilder("pw", seed=2)
    x = b.input("x", (2, 5, 5, 24))
    b.mark_output(b.conv2d(x, 16, 1, padding=1, bias=True))
    gr = b.build()
    r_optimize(gr, quant=R.QuantConfig(conv1x1_dot=True), calib_batches=calib)
    assert next(o for o in gr.ops if o.op_type == "conv2d").attrs.get("conv1x1_dot")
    gp = _pw_graph(24, 1)
    optimize(gp, quant=P.QuantConfig(conv1x1_dot=True), calib_batches=calib, device="cpu")
    convs = [o for o in gp.ops if o.op_type == "conv2d"]
    assert not convs[0].attrs.get("conv1x1_dot") and convs[1].attrs.get("conv1x1_dot")
    for o in gp.ops:
        o.attrs.pop("kernel", None)
    want = testing.capture_all(gp, P.stage_weights(gp, CPU), calib[0], CPU)
    convs[0].attrs["conv1x1_dot"] = True  # forced: the op keeps the conv form
    got = testing.capture_all(gp, P.stage_weights(gp, CPU), calib[0], CPU)
    assert tuple(got[gp.outputs[0]].shape) == (2, 7, 7, 8)
    assert all(torch.equal(got[n], want[n]) for n in want)
