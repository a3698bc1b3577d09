"""ResNet-50 INT8 through both packages: the model, its optimized graph, the
kernel tags, and the int8 logits.

Small sizes (batch 2, 32 px: the full ResNet-50 widths and depth, as the
kernel tags and K depend only on them); inputs are made with numpy from a
seed and handed to both packages.

Tolerances, and why:
- graphs and weights: identical; the optimized graph is compared from the
  same calibration scales (the JAX package's), so scales match exactly.
- the pieces ResNet-50 adds to the pipeline (the fp32 7x7 stem, the int8
  3x3/s2 max pool, the shortcut add fused into a conv with an int8
  operand, the int8 global average pool), each op fed the same inputs in
  both packages: integer outputs exact but for requant ties (at most
  ``testing.TIE_COUNT`` elements or ``TIE_FRACTION`` of them, by
  ``TIE_LSB``: the fp32 stem's sums run in another order in XLA and torch).
- end to end: logits cosine > 0.999 against the JAX package's int8 graph
  (ties spread through 53 convs, as in ``test_torch_main_path.py``), and
  > 0.98 int8 against the port's own fp32 predictor
  (``tests/test_models.py:41``).
"""

import numpy as np
import pytest
import torch

import jax

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.executor import ExecutionContext as RContext
from paddle_lite_tpu.core.pass_manager import PassManager as RPassManager
from paddle_lite_tpu.core.registry import OPS as ROPS
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.models import resnet as r_resnet
from paddle_lite_tpu.quant.calibrate import calibrate as r_calibrate
from paddle_lite_tpu.tools.opt import FUSION_PASSES as R_FUSION
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core.executor import ExecutionContext
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import mobilenet_v1, mobilenet_v3, resnet, ssd
from paddle_lite_tpu_torch.ops.kernels import int8_matmul
from paddle_lite_tpu_torch.quant.calibrate import CalibrationResult
from paddle_lite_tpu_torch.runtime.predictor import create_predictor
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
KW = dict(batch=2, image_size=32, num_classes=50, seed=3, with_softmax=False)
SHAPE = (2, 32, 32, 3)
# an fp32 conv is exact for every int8 input only while K·127² < 2^24
FP32_EXACT_K = 1040


def _feeds(n, seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=shape).astype(np.float32)} for _ in range(n)]


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


# ---- the model ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    KW,
    dict(batch=1, image_size=32, seed=1, ablate_residual=True),
    dict(batch=1, image_size=32, seed=2, ablate_stem=True),
    dict(batch=1, image_size=32, seed=4, ablate_head=True),
])
def test_build_identical(kw):
    _assert_same_graph(r_resnet.build(**kw), resnet.build(**kw))


@pytest.fixture(scope="module")
def pair():
    """Both packages' optimized graphs from the JAX package's scales."""
    seen = r_resnet.build(**KW)
    RPassManager(R_FUSION).run(seen)
    result = r_calibrate(seen, _feeds(2, 1))
    gr, gp = r_resnet.build(**KW), resnet.build(**KW)
    r_optimize(gr, quant=R.QuantConfig(), calib_result=result)
    optimize(gp, quant=P.QuantConfig(), device="cpu",
             calib_result=CalibrationResult(scales=dict(result.scales)))
    return gr, gp


def test_optimized_graph_matches_reference(pair):
    """Same op types, attrs, int8 marks, scales and int8 weights; every
    batch_norm folded and every shortcut add fused."""
    gr, gp = pair
    _assert_same_graph(gr, gp, skip_attrs=("kernel",))
    assert not [o for o in gp.ops if o.op_type in ("batch_norm", "elementwise_add")]
    assert [o.op_type for o in gp.ops].count("conv2d") == 53


def test_kernel_tags(pair):
    """53 GEMM ops: 16 reduce 1x1, 16 3x3 through im2col (3 at stride 2),
    the 4 expansion convs of the projection blocks, the 16 convs that carry
    the shortcut and the fc.  The shortcut add fuses into the first conv
    that feeds it (``conv_elementwise_fuse``, as in the reference): the
    projection conv in those 4 blocks, the expansion conv in the other 12;
    its int8 residual goes into the GEMM's epilogue.  Only the fp32 stem
    stays on torch."""
    _, gp = pair
    cuda = [o for o in gp.ops if o.attrs.get("kernel") == "cuda"]
    assert len(cuda) == 53
    assert all(o.op_type in ("conv2d", "fc") for o in cuda)
    convs = [o for o in cuda if o.op_type == "conv2d"]
    ks = [gp.vars[o.input("Filter")].shape[:2] for o in convs]
    assert (ks.count((1, 1)), ks.count((3, 3))) == (36, 16)
    residual = [o for o in convs if o.maybe_input("ResidualData")]
    assert len(residual) == 16 and all(o.attrs.get("enable_int8") for o in residual)
    assert all(gp.vars[o.input("Filter")].shape[:2] == (1, 1) for o in residual)
    assert sum(o.attrs["strides"] == [2, 2] for o in residual) == 3  # projections
    assert all(gp.vars[o.input("ResidualData")].precision.value == "int8" for o in residual)
    strided = [o for o in convs if o.attrs["strides"] != [1, 1]]
    assert len(strided) == 6 and all(
        gp.vars[o.input("Filter")].shape[:2] == (3, 3) for o in strided
        if not o.maybe_input("ResidualData"))
    torch_convs = [o for o in gp.ops if o.op_type == "conv2d" and "kernel" not in o.attrs]
    assert len(torch_convs) == 1 and not torch_convs[0].attrs.get("enable_int8")
    assert gp.vars[torch_convs[0].input("Filter")].shape[:2] == (7, 7)


def _optimized(model):
    if model == "resnet":
        g, shape = resnet.build(batch=2, image_size=32, seed=0), SHAPE
    elif model == "ssd":
        g, shape = ssd.build(batch=2, image_size=160, num_classes=5, seed=0), (2, 160, 160, 3)
    elif model == "mobilenet_v1":
        g, shape = mobilenet_v1.build(batch=2, image_size=32, seed=0), SHAPE
    else:
        g, shape = mobilenet_v3.build(batch=2, image_size=32, seed=0), SHAPE
    optimize(g, quant=P.QuantConfig(), calib_batches=_feeds(1, 0, shape), device="cpu")
    return g


@pytest.mark.parametrize("model", ["resnet", "ssd", "mobilenet_v1", "mobilenet_v3"])
def test_no_int8_conv_past_the_fp32_exact_k_on_torch(model):
    """Every int8 conv2d left on the "torch" route (an fp32 conv, then
    round) has K = kh·kw·C <= 1040, where every partial sum stays below
    2^24; the others run on the GEMM, whose int32 accumulator is exact."""
    g = _optimized(model)
    left = [o for o in g.ops if o.op_type == "conv2d" and o.attrs.get("enable_int8")
            and o.attrs.get("kernel") != "cuda"]
    ks = [int(np.prod(g.vars[o.input("Filter")].shape[:3])) for o in left]
    assert max(ks, default=0) <= FP32_EXACT_K, ks
    assert not left  # residual convs too: their int8 residual is in the GEMM's epilogue


# ---- the pieces ResNet-50 adds, op by op against the reference ----------------

def _ref_env(gr, feed):
    env = {}
    R.build_callable(gr, platform="cpu", capture=lambda n, v: env.__setitem__(n, v))(
        R.stage_weights(gr), feed)
    return env


@pytest.mark.parametrize("piece", ["stem", "max_pool", "residual_conv", "residual_conv.cuda",
                                   "global_avg_pool"])
def test_pipeline_piece_vs_reference(pair, piece):
    """One op of the optimized graph in both packages ("torch" in the port,
    "xla" in the reference) on the inputs the reference run gave it;
    ``residual_conv.cuda`` runs the port's "cuda" impl of the residual
    convs (the GEMM's plain version on the CPU, its residual in the
    epilogue)."""
    gr, gp = pair
    piece, impl = (piece.split(".") + ["torch"])[:2]
    ops = {
        "stem": [o for o in gp.ops if o.op_type == "conv2d" and not o.attrs.get("enable_int8")],
        "max_pool": [o for o in gp.ops if o.op_type == "pool2d"
                     and o.attrs.get("pooling_type") == "max"],
        "residual_conv": [o for o in gp.ops if o.maybe_input("ResidualData")],
        "global_avg_pool": [o for o in gp.ops if o.op_type == "pool2d"
                            and o.attrs.get("global_pooling")],
    }[piece]
    assert ops
    env = _ref_env(gr, _feeds(1, 5)[0])
    env.update({n: jax.numpy.asarray(a) for n, a in gr.weights.items()})
    rctx, ctx = RContext(graph=gr, platform="cpu"), ExecutionContext(graph=gp, device=CPU)
    r_ops = {tuple(o.outputs.items())[0][1][0]: o for o in gr.ops}
    for op in ops:
        out = next(iter(op.outputs.values()))[0]
        rop = r_ops[out]
        r_ins = {s: [env[n] for n in ns] for s, ns in rop.inputs.items() if ns}
        p_ins = {s: [torch.from_numpy(np.array(env[n])) for n in ns]
                 for s, ns in op.inputs.items() if ns}
        ref = np.asarray(next(iter(ROPS.get(rop.op_type).impls["xla"](rctx, rop, r_ins)
                                   .values()))[0])
        got = next(iter(OPS.get(op.op_type).impls[impl](ctx, op, p_ins).values()))[0].numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, out
        if piece in ("max_pool", "residual_conv", "global_avg_pool"):
            assert got.dtype == np.int8, out
        if piece == "residual_conv":
            assert p_ins["ResidualData"][0].dtype == torch.int8
        if got.dtype == np.int8:
            d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
            assert d.max() <= testing.TIE_LSB, out
            assert (d > 0).sum() <= max(testing.TIE_COUNT, testing.TIE_FRACTION * d.size), out
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ---- end to end --------------------------------------------------------------

def test_int8_logits_vs_reference_and_fp32(pair):
    gr, gp = pair
    feed = _feeds(1, 3)[0]
    out = gr.outputs[0]
    ref = np.asarray(jax.device_get(
        R.build_callable(gr, platform="cpu")(R.stage_weights(gr), feed)[out]))
    int8_matmul.launches = 0
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)[out].numpy()
    assert int8_matmul.launches == 0  # CPU: the plain version
    assert got.shape == (2, 50) and np.isfinite(got).all()
    assert _cos(got, ref) > 0.999
    fp32 = create_predictor(resnet.build(**KW), device="cpu").run(feed)[out].numpy()
    assert _cos(got, fp32) > 0.98


def test_interop_carries_the_weights(pair):
    """The reference's optimized graph, carried across, is the port's own
    optimized graph with the same int8 weights and scales, and runs to the
    same logits on the "cuda" tags."""
    gr, gp = pair
    gx = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    _assert_same_graph(gr, gx, skip_attrs=("kernel",))
    for o in gx.ops:
        o.attrs.pop("kernel", None)
    for a, b in zip(gp.ops, gx.ops):
        if "kernel" in a.attrs:
            b.attrs["kernel"] = a.attrs["kernel"]
    feed = _feeds(1, 4)[0]
    out = gp.outputs[0]
    a = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)[out]
    b = P.build_callable(gx, device=CPU)(P.stage_weights(gx, CPU), feed)[out]
    assert torch.equal(a, b)


def test_benchmark_tool_runs_resnet():
    """``tools.benchmark`` resolves "resnet" to the port's model now."""
    from paddle_lite_tpu_torch.tools import benchmark

    assert benchmark.resolve_builder("resnet") is resnet.build
    got = benchmark.bench_model("resnet", batch=1, image_size=32, device="cpu")
    assert got["model"] == "resnet" and got["int8_items_per_sec"] > 0
