"""The fused depthwise + pointwise block (``fused_dw_pw``) in both packages.

Small sizes; inputs are made with numpy from a seed and handed to both.

Tolerances, and why:
- the pass: the port, given the JAX package's calibration scales, forms
  the identical ops, attrs (``dw_out_scale`` included), scales and weights.
- the kernel's plain version against the JAX kernel in interpret mode:
  int8 outputs equal, except that the reference's XLA may multiply by the
  reciprocal of hard_swish's scale or contract ``y·s + b`` into one FMA,
  one fp32 ulp off the port's separate roundings, which flips a requant
  tie: at most ``TIE_COUNT`` elements may differ, by 1 LSB (1 of 15,680
  in the hard_swish case below, none elsewhere).  fp32 outputs rtol 1e-6
  (the same ulp).
- the ``"torch"`` form against ``fused_dw_pw_xla``: int8 equal, fp32 rtol
  1e-6.
- MobileNetV1 end to end: the bounds of ``test_torch_main_path.py``.
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
from paddle_lite_tpu.models import mobilenet_v1 as r_mnv1
from paddle_lite_tpu.ops.kernels import depthwise as r_dw
from paddle_lite_tpu.ops.kernels.dw_pw_fused import fused_dw_pw_int8 as r_fused
from paddle_lite_tpu.quant.calibrate import calibrate as r_calibrate
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import mobilenet_v1 as p_mnv1
from paddle_lite_tpu_torch.ops.kernels import depthwise as p_dw
from paddle_lite_tpu_torch.ops.kernels import dw_pw_fused as p_fused
from paddle_lite_tpu_torch.quant.calibrate import CalibrationResult
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
TIE_COUNT = 2
FP32_RTOL = 1e-6
INT8_FRACTION, INT8_LSB = 1e-2, 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- the pass ---------------------------------------------------------------

def _block_model(pkg, batch=2, hw=8, c=16, oc=32, stride=1):
    """``tests/test_dw_pw_fused.py:_block_model``, in either package."""
    b = pkg.GraphBuilder("m", seed=111)
    x = b.input("x", (batch, hw, hw, c))
    y = b.conv_bn_act(x, c, 3, stride=stride, padding=1, depthwise=True, act="relu")
    y = b.conv_bn_act(y, oc, 1, act="relu")
    y = b.conv_bn_act(y, oc, 3, padding=1, depthwise=True, act="relu")
    y = b.conv_bn_act(y, oc, 1, act="relu")
    y = b.pool2d(y, "avg", global_pooling=True)
    y = b.reshape(y, (batch, oc))
    y = b.fc(y, 10)
    b.mark_output(y)
    return b.build()


def _multi_use_model(pkg):
    """A dw output consumed twice (``test_fuse_skipped_when_dw_output_multiuse``)."""
    b = pkg.GraphBuilder("m", seed=112)
    x = b.input("x", (1, 8, 8, 16))
    y = b.conv_bn_act(x, 16, 3, padding=1, depthwise=True, act="relu")
    z1 = b.conv_bn_act(y, 32, 1, act="relu")
    z2 = b.conv_bn_act(y, 32, 1, act="relu")
    b.mark_output(b.eltwise(z1, z2, "add"))
    return b.build()


def _optimized_both(make, x_shape):
    """Optimize `make(pkg)` with fuse_dw_pw in both packages, from the same
    calibration scales (the JAX package's)."""
    from paddle_lite_tpu.core.pass_manager import PassManager
    from paddle_lite_tpu.tools.opt import FUSION_PASSES

    rng = np.random.default_rng(0)
    calib = [{"x": rng.normal(size=x_shape).astype(np.float32)}]
    seen = make(R)  # what calibration observes: the graph after the fusions
    PassManager(FUSION_PASSES).run(seen)
    result = r_calibrate(seen, calib)
    gr, gp = make(R), make(P)
    r_optimize(gr, quant=R.QuantConfig(fuse_dw_pw=True), calib_result=result)
    optimize(gp, quant=P.QuantConfig(fuse_dw_pw=True), device="cpu",
             calib_result=CalibrationResult(scales=dict(result.scales)))
    return gr, gp


@pytest.mark.parametrize("case,n_fused", [
    ("blocks", 2),
    ("multi_use", 0),     # the dw output has two consumers
    ("wide", 1),          # C = 160 > 128 on the first block
    ("stride2", 1),       # the first dw has stride 2
])
def test_pass_forms_the_reference_ops(case, n_fused):
    make, shape = {
        "blocks": (lambda pkg: _block_model(pkg), (2, 8, 8, 16)),
        "multi_use": (_multi_use_model, (1, 8, 8, 16)),
        "wide": (lambda pkg: _block_model(pkg, c=160, oc=32), (2, 8, 8, 160)),
        "stride2": (lambda pkg: _block_model(pkg, stride=2), (2, 8, 8, 16)),
    }[case]
    gr, gp = _optimized_both(make, shape)
    assert [o.op_type for o in gr.ops] == [o.op_type for o in gp.ops]
    assert sum(o.op_type == "fused_dw_pw" for o in gp.ops) == n_fused
    for a, b in zip(gr.ops, gp.ops):
        assert a.inputs == b.inputs and a.outputs == b.outputs
        ka = {k: v for k, v in a.attrs.items() if k != "kernel"}
        kb = {k: v for k, v in b.attrs.items() if k != "kernel"}
        assert ka == kb, (a.op_type, ka, kb)
        if a.op_type == "fused_dw_pw":
            assert a.attrs["kernel"] == "pallas" and b.attrs["kernel"] == "cuda"
    for n, v in gr.vars.items():
        w = gp.vars[n]
        assert v.precision.value == w.precision.value and v.shape == w.shape, n
        assert (v.quant is None) == (w.quant is None), n
        if v.quant is not None:
            assert v.quant.scale == w.quant.scale, n
    assert sorted(gr.weights) == sorted(gp.weights)
    for n, a in gr.weights.items():
        assert np.array_equal(np.asarray(a), gp.weights[n]), n
    if case == "multi_use":
        assert "depthwise_conv2d" in [o.op_type for o in gp.ops]


def test_dw_out_scale_is_the_dw_output_scale():
    """The fused op's internal requant scale is the same fp32 number as the
    unfused graph's dw output var scale, so the two compute the same
    int8 intermediate."""
    rng = np.random.default_rng(1)
    calib = [{"x": rng.normal(size=(2, 8, 8, 16)).astype(np.float32)}]
    g1, g2 = _block_model(P), _block_model(P)
    optimize(g1, quant=P.QuantConfig(), calib_batches=calib, device="cpu")
    optimize(g2, quant=P.QuantConfig(), calib_batches=calib, device="cpu",
             fuse_dw_pw=True)
    dws = [o for o in g1.ops if o.op_type == "depthwise_conv2d"]
    fused = [o for o in g2.ops if o.op_type == "fused_dw_pw"]
    assert len(dws) == len(fused) == 2
    for dw, f in zip(dws, fused):
        s = g1.vars[dw.output("Output")].quant.scale[0]
        assert np.float32(f.attrs["dw_out_scale"]) == np.float32(s)
        assert f.attrs["dw_out_scale"] == dw.attrs["out_scale"]


@pytest.mark.parametrize("cfg", [dict(quant=dict(fuse_dw_pw=True)),
                                 dict(quant={}, fuse_dw_pw=True)])
def test_optimize_fuse_dw_pw_no_longer_raises(cfg):
    g = p_mnv1.build(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0)
    rng = np.random.default_rng(2)
    optimize(g, quant=P.QuantConfig(**cfg["quant"]), device="cpu",
             fuse_dw_pw=cfg.get("fuse_dw_pw", False),
             calib_batches=[{"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32)}])
    assert sum(o.op_type == "fused_dw_pw" for o in g.ops) == 8
    assert all(o.attrs["kernel"] == "cuda" for o in g.ops if o.op_type == "fused_dw_pw")


# ---- the kernel's plain version against the Pallas kernel ------------------

def _fused_problem(rng, n, h, c, o):
    x = rng.integers(-127, 128, size=(n, h, h, c), dtype=np.int8)
    dw = rng.integers(-127, 128, size=(3, 3, 1, c), dtype=np.int8)
    pw = rng.integers(-127, 128, size=(c, o), dtype=np.int8)
    dw_eff = rng.uniform(1e-3, 2e-3, size=c).astype(np.float32)
    dw_b = rng.normal(0, 0.5, size=c).astype(np.float32)
    pw_eff = rng.uniform(1e-3, 2e-3, size=o).astype(np.float32)
    pw_b = rng.normal(0, 0.5, size=o).astype(np.float32)
    return x, dw, dw_eff, dw_b, pw, pw_eff, pw_b


def _held(got: np.ndarray, ref: np.ndarray) -> int:
    """Asserts the module's bounds; returns the count of int8 ties."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype == np.int8:
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert d.max() <= 1 and (d > 0).sum() <= TIE_COUNT
        return int((d > 0).sum())
    np.testing.assert_allclose(got, ref, rtol=FP32_RTOL, atol=1e-6)
    return 0


@pytest.mark.parametrize("h", [7, 8])
@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("o", [32, 160])
@pytest.mark.parametrize("int8_out", [True, False])
def test_plain_vs_pallas(h, c, o, int8_out):
    rng = np.random.default_rng(h * 1000 + c * 10 + o)
    x, dw, de, db, pw, pe, pb = _fused_problem(rng, 2, h, c, o)
    kw = dict(dw_act="relu", pw_act="relu", pw_out_scale=0.1 if int8_out else None)
    ref = np.asarray(r_fused(x, dw, de, db, 0.05, pw, pe, pb, interpret=True, **kw))
    got = p_fused.fused_dw_pw_int8(_t(x), _t(dw), _t(de), _t(db), 0.05, _t(pw),
                                   _t(pe), _t(pb), **kw).numpy()
    assert _held(got, ref) == 0


@pytest.mark.parametrize("dw_act,dw_attrs,pw_act,pw_attrs", [
    ("hard_swish", {}, "hard_sigmoid", {"slope": 0.2, "offset": 0.5}),
    ("leaky_relu", {"alpha": 0.1}, "hard_swish", {}),
    ("relu6", {}, None, {}),
])
@pytest.mark.parametrize("int8_out", [True, False])
def test_plain_vs_pallas_activations(dw_act, dw_attrs, pw_act, pw_attrs, int8_out):
    rng = np.random.default_rng(876)
    x, dw, de, db, pw, pe, pb = _fused_problem(rng, 2, 7, 16, 160)
    kw = dict(dw_act=dw_act, dw_act_attrs=dw_attrs, pw_act=pw_act,
              pw_act_attrs=pw_attrs, pw_out_scale=0.1 if int8_out else None)
    ref = np.asarray(r_fused(x, dw, de, db, 0.05, pw, pe, pb, interpret=True, **kw))
    got = p_fused.fused_dw_pw_int8(_t(x), _t(dw), _t(de), _t(db), 0.05, _t(pw),
                                   _t(pe), _t(pb), **kw).numpy()
    # the one tie this seed hits: pw hard_swish's division, int8 out
    assert _held(got, ref) == int(pw_act == "hard_swish" and int8_out)


def test_plain_no_bias_and_4d_pw_weight():
    rng = np.random.default_rng(8)
    x, dw, de, _, pw, pe, _ = _fused_problem(rng, 1, 8, 16, 32)
    ref = np.asarray(r_fused(x, dw, de, None, 0.07, pw.reshape(1, 1, 16, 32), pe,
                             None, pw_out_scale=0.2, interpret=True))
    got = p_fused.fused_dw_pw_int8(_t(x), _t(dw), _t(de), None, 0.07,
                                   _t(pw.reshape(1, 1, 16, 32)), _t(pe), None,
                                   pw_out_scale=0.2).numpy()
    assert _held(got, ref) == 0


@pytest.mark.parametrize("attrs,x_shape,w_shape", [
    ({"strides": [1, 1], "paddings": [1, 1]}, (1, 8, 8, 16), (3, 3, 1, 16)),
    ({"strides": [2, 2], "paddings": [1, 1]}, (1, 8, 8, 16), (3, 3, 1, 16)),
    ({"strides": [1, 1], "paddings": [2, 2]}, (1, 8, 8, 16), (5, 5, 1, 16)),
    ({"strides": [1, 1], "paddings": [0, 0]}, (1, 8, 8, 16), (3, 3, 1, 16)),
    ({"strides": [1, 1], "paddings": [1, 1], "dilations": [2, 2]},
     (1, 8, 8, 16), (3, 3, 1, 16)),
    ({"strides": [1, 1], "paddings": [1, 1]}, (1, 8, 8, 16), (3, 3, 1, 32)),
])
def test_dw_supported_matches_reference(attrs, x_shape, w_shape):
    assert p_dw.supported(attrs, x_shape, w_shape) is \
        r_dw.supported(attrs, x_shape, w_shape)


# ---- the "torch" form against fused_dw_pw_xla --------------------------------

@pytest.mark.parametrize("int8_out", [True, False])
@pytest.mark.parametrize("pw_act", ["relu", "hard_swish"])
def test_torch_form_vs_xla_impl(int8_out, pw_act):
    rng = np.random.default_rng(9)
    c, o = 16, 24
    g = RGraph("t")
    v = g.add_var("x", (2, 7, 7, c), precision=RPrecision.INT8)
    v.quant = RQuant.per_tensor(0.02)
    g.inputs.append("x")
    for name, shape in (("dw", (3, 3, 1, c)), ("pw", (1, 1, c, o))):
        w = g.add_weight(name, rng.integers(-127, 128, size=shape, dtype=np.int8))
        w.quant = RQuant.per_channel_scales(
            rng.uniform(0.5e-2, 2e-2, size=shape[3]).astype(np.float32), 3)
    g.add_weight("db", rng.normal(0, 0.3, size=c).astype(np.float32))
    g.add_weight("pb", rng.normal(0, 0.3, size=o).astype(np.float32))
    y = g.add_var("y", (2, 7, 7, o), precision=RPrecision.INT8 if int8_out
                  else RPrecision.FP32)
    attrs = {"enable_int8": True, "kernel": "xla", "dw_act": "relu",
             "dw_act_attrs": {}, "dw_out_scale": 0.05, "pw_act": pw_act,
             "pw_act_attrs": {}}
    if int8_out:
        y.quant = RQuant.per_tensor(0.1)
        attrs["out_scale"] = 0.1
    g.outputs.append("y")
    g.add_op("fused_dw_pw", {"Input": ["x"], "DwFilter": ["dw"], "PwFilter": ["pw"],
                             "DwBias": ["db"], "PwBias": ["pb"]},
             {"Output": ["y"]}, attrs)
    g.rebuild_links()
    feed = {"x": rng.integers(-127, 128, size=(2, 7, 7, c), dtype=np.int8)}
    ref = np.asarray(jax.device_get(
        R.build_callable(g, platform="cpu")(R.stage_weights(g), feed)["y"]))
    gp = graph_from_reference(artifact.graph_to_meta(g), g.weights)
    assert gp.ops[0].attrs["kernel"] == "torch"
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)["y"].numpy()
    assert got.dtype == ref.dtype
    if int8_out:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=FP32_RTOL, atol=1e-6)


# ---- MobileNetV1 with fuse_dw_pw, port against JAX ---------------------------

KW = dict(batch=2, image_size=32, width_mult=0.25, num_classes=10, seed=0)


def _feeds(n, seed):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("ref_tag", ["pallas", "xla"])
def test_mobilenet_v1_fused_end_to_end(ref_tag):
    """(a) JAX with the Pallas kernels (interpret mode) vs the port's "cuda"
    tags; (b) JAX "xla" vs the port's "torch" tags: every int8 tensor and
    the softmax."""
    gr = r_mnv1.build(**KW)
    r_optimize(gr, quant=R.QuantConfig(fuse_dw_pw=True), calib_batches=_feeds(2, 1))
    for op in gr.ops:
        if op.attrs.get("kernel") in ("xla", "pallas"):
            op.attrs["kernel"] = ref_tag
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    assert sum(o.op_type == "fused_dw_pw" for o in gp.ops) == 8
    feed = _feeds(1, 2)[0]
    env = {}
    R.build_callable(gr, platform="cpu", capture=lambda n, v: env.__setitem__(n, v))(
        R.stage_weights(gr), feed)
    ref = {k: np.asarray(jax.device_get(v)) for k, v in env.items()}
    got = testing.capture_all(gp, P.stage_weights(gp, CPU), feed, CPU)
    n_int8 = 0
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if r.dtype == np.int8:
            n_int8 += 1
            d = np.abs(g.astype(np.int32) - r.astype(np.int32))
            assert d.max() <= INT8_LSB and (d > 0).mean() <= INT8_FRACTION, name
    assert n_int8 >= 19
    out = gr.outputs[0]
    np.testing.assert_allclose(got[out].numpy(), ref[out], rtol=0,
                               atol=testing.SOFTMAX_ATOL)


def test_fused_ops_local_checks_on_cpu():
    """On the CPU the "cuda" fused op runs its plain version: it equals the
    unfused pair and the plain version exactly, and every other kernel op
    stays within the tie bound of its torch op."""
    g = p_mnv1.build(**KW)
    optimize(g, quant=P.QuantConfig(fuse_dw_pw=True), calib_batches=_feeds(1, 3),
             device="cpu")
    w = P.stage_weights(g, CPU)
    feed = _feeds(1, 4)[0]
    fused = testing.fused_local_diffs(g, w, feed, CPU)
    assert len(fused) == 16 and all(d["n_diff"] == 0 for d in fused)
    local = testing.op_local_diffs(g, w, feed, CPU)
    assert len(local) == 11 and testing.within_tie_bound(local)


def test_fused_cuda_impl_raises_on_float_input():
    g = p_mnv1.build(**KW)
    optimize(g, quant=P.QuantConfig(fuse_dw_pw=True), calib_batches=_feeds(1, 3),
             device="cpu")
    op = next(o for o in g.ops if o.op_type == "fused_dw_pw")
    ins = {"Input": [torch.zeros(g.vars[op.input("Input")].shape)],
           "DwFilter": [torch.zeros(3, 3, 1, 8, dtype=torch.int8)],
           "PwFilter": [torch.zeros(1, 1, 8, 16, dtype=torch.int8)]}
    from paddle_lite_tpu_torch.core.executor import ExecutionContext
    from paddle_lite_tpu_torch.core.registry import OPS

    with pytest.raises(ValueError, match="int8"):
        OPS.get("fused_dw_pw").impls["cuda"](ExecutionContext(g, CPU), op, ins)


# ---- on the card: the CUDA kernel against its plain version ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "python3 chip_smoke.py runs the full check on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,h,w,c,o", [(2, 9, 150, 16, 32), (2, 7, 13, 30, 160)])
def test_fused_kernel_vs_plain_on_card(cuda_device, n, h, w, c, o):
    rng = np.random.default_rng(0)
    x = _t(rng.integers(-127, 128, size=(n, h, w, c), dtype=np.int8)).to(cuda_device)
    _, dw, de, db, pw, pe, pb = (_t(a).to(cuda_device)
                                 for a in _fused_problem(rng, 1, 1, c, o))
    for out_scale in (None, 0.1):
        kw = dict(dw_act="hard_swish", pw_act="relu", pw_out_scale=out_scale)
        got = p_fused.fused_dw_pw_int8(x, dw, de, db, 0.05, pw, pe, pb, **kw)
        ref = p_fused.fused_dw_pw_int8_plain(x, dw, de, db, 0.05, pw, pe, pb, **kw)
        assert torch.equal(got, ref)
