"""The int8 conv's GEMM route — ``ops_cuda.im2col_nhwc`` into
``int8_matmul`` under the ``"cuda"`` tag — against the JAX package.

On the CPU the route runs the GEMM's plain version (a float64 matmul, exact
below 2^53), so these tests hold the route's own result.  One-op graphs are
built with the reference's IR and carried across with
``graph_from_reference``, so both packages run the identical op, attrs and
scales; inputs are made with numpy from a seed.

Tolerances, and why:
- int8 outputs against the reference's ``conv2d_xla`` (on the CPU an fp32
  conv then ``round``, exact at these K): the kernels requantize with
  ``y·fp32(1/s)``, the reference's XLA path with ``y / s``, so at most
  ``testing.TIE_COUNT`` elements (or ``TIE_FRACTION`` of them) may differ,
  by ``TIE_LSB``;
- fp32 outputs: rtol 1e-6 (XLA may contract ``acc·s + b`` into one FMA, one
  fp32 ulp off the port's separate roundings), atol 1e-6 where the sum
  cancels;
- with scale 1, no bias and fp32 out: exactly the int32 accumulator of
  ``jax.lax.conv_general_dilated(..., preferred_element_type=jnp.int32)``
  converted once to fp32 — the reference's epilogue on its target.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.ir import Graph as RGraph
from paddle_lite_tpu.core.types import Precision as RPrecision
from paddle_lite_tpu.core.types import QuantInfo as RQuant
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core.builder import GraphBuilder
from paddle_lite_tpu_torch.core.types import Precision, QuantInfo
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.ops.kernels import int8_matmul
from paddle_lite_tpu_torch.ops.kernels.ops_cuda import im2col_nhwc
from paddle_lite_tpu_torch.ops.kernels.select import choose_kernel, gemm_eligible

CPU = torch.device("cpu")
FP32_RTOL = FP32_ATOL = 1e-6

# name: (N, H, W, C, k, stride, paddings, OC)
GEOMETRIES = {
    "1x1_s1": (2, 9, 9, 16, 1, 1, [0, 0], 24),
    "1x1_s2": (2, 9, 9, 16, 1, 2, [0, 0], 24),
    "3x3_s1_p1": (2, 9, 9, 16, 3, 1, [1, 1], 24),
    "3x3_s2_p1": (2, 9, 9, 16, 3, 2, [1, 1], 24),
    "3x3_s2_pads_0101": (2, 10, 10, 16, 3, 2, [0, 1, 0, 1], 24),
    "3x3_s2_p1_odd_hw": (2, 7, 11, 18, 3, 2, [1, 1], 20),
    "7x7_s2_p3_n1": (1, 13, 13, 8, 7, 2, [3, 3], 16),
    "3x3_s1_p1_n1": (1, 5, 6, 32, 3, 1, [1, 1], 30),
}


def _pad_pairs(pads):
    """Paddle's [h, w] or [top, bottom, left, right] as ((t, b), (l, r))."""
    return ((pads[0], pads[0]), (pads[1], pads[1])) if len(pads) == 2 \
        else ((pads[0], pads[1]), (pads[2], pads[3]))


def _one_conv(geom, *, x_scale=0.02, w_scales=None, bias=True, act="relu",
              out_scale=None, x=None, w=None, seed=0, residual_scale=None):
    """A reference graph holding one int8 conv2d, and its feed; with
    ``residual_scale`` an int8 residual input "r" at that per-tensor scale."""
    n, h, wd, c, k, s, pads, oc = geom
    rng = np.random.default_rng(seed)
    g = RGraph("t")
    v = g.add_var("x", (n, h, wd, c), precision=RPrecision.INT8)
    v.quant = RQuant.per_tensor(x_scale)
    g.inputs.append("x")
    w = rng.integers(-127, 128, size=(k, k, c, oc), dtype=np.int8) if w is None else w
    wv = g.add_weight("w", w)
    wv.quant = RQuant.per_channel_scales(
        rng.uniform(0.5e-3, 2e-3, size=oc).astype(np.float32) if w_scales is None
        else np.asarray(w_scales, np.float32), 3)
    ins = {"Input": ["x"], "Filter": ["w"]}
    if bias:
        g.add_weight("b", rng.normal(0, 0.3, size=(oc,)).astype(np.float32))
        ins["Bias"] = ["b"]
    (pt, pb), (pl, pr) = _pad_pairs(pads)
    oh, ow = (h + pt + pb - k) // s + 1, (wd + pl + pr - k) // s + 1
    y = g.add_var("y", (n, oh, ow, oc),
                  precision=RPrecision.INT8 if out_scale else RPrecision.FP32)
    attrs = {"strides": [s, s], "paddings": list(pads), "dilations": [1, 1],
             "groups": 1, "enable_int8": True}
    if act:
        attrs["fuse_act"] = act
    if out_scale:
        y.quant = RQuant.per_tensor(out_scale)
        attrs["out_scale"] = out_scale
    feed = {}
    if residual_scale:
        r = g.add_var("r", (n, oh, ow, oc), precision=RPrecision.INT8)
        r.quant = RQuant.per_tensor(residual_scale)
        g.inputs.append("r")
        ins["ResidualData"] = ["r"]
        feed["r"] = rng.integers(-127, 128, size=(n, oh, ow, oc), dtype=np.int8)
    g.outputs.append("y")
    g.add_op("conv2d", ins, {"Output": ["y"]}, attrs)
    g.rebuild_links()
    if x is None:
        x = rng.integers(-127, 128, size=(n, h, wd, c), dtype=np.int8)
    return g, {"x": x, **feed}


def _run_port_cuda(g: RGraph, feed) -> np.ndarray:
    """The reference graph in the port, its conv on the "cuda" route."""
    gp = graph_from_reference(artifact.graph_to_meta(g), g.weights)
    conv = next(o for o in gp.ops if o.op_type == "conv2d")
    assert choose_kernel(gp, conv) == "cuda"
    conv.attrs["kernel"] = "cuda"
    int8_matmul.launches = 0
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)["y"]
    assert int8_matmul.launches == 0  # CPU: the plain version
    return got.numpy()


def _run_reference(g: RGraph, feed) -> np.ndarray:
    out = R.build_callable(g, platform="cpu")(R.stage_weights(g), feed)
    return np.asarray(jax.device_get(out["y"]))


def _int32_acc(x: np.ndarray, w: np.ndarray, stride: int, pads) -> np.ndarray:
    """The reference's accumulator on its target: an int8 conv accumulated
    in int32 (``nn.py:149-160`` there, off the CPU)."""
    (pt, pb), (pl, pr) = _pad_pairs(pads)
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(stride, stride),
        padding=((pt, pb), (pl, pr)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


# ---- the route against the reference's conv2d_xla ---------------------------

@pytest.mark.parametrize("out", ["int8", "fp32"])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_cuda_conv_route_vs_reference(name, out):
    g, feed = _one_conv(GEOMETRIES[name], out_scale=0.05 if out == "int8" else None,
                        act="relu" if out == "int8" else None,
                        seed=sorted(GEOMETRIES).index(name))
    ref, got = _run_reference(g, feed), _run_port_cuda(g, feed)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if out == "int8":
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert d.max() <= testing.TIE_LSB
        assert (d > 0).sum() <= max(testing.TIE_COUNT, testing.TIE_FRACTION * d.size)
    else:
        np.testing.assert_allclose(got, ref, rtol=FP32_RTOL, atol=FP32_ATOL)


@pytest.mark.parametrize("out", ["int8", "fp32"])
@pytest.mark.parametrize("name", ["1x1_s1", "1x1_s2", "3x3_s1_p1", "3x3_s1_p1_n1"])
def test_cuda_conv_route_with_residual_vs_reference(name, out):
    """An int8 residual in the GEMM's epilogue (the port's plain version on
    the CPU) against the reference's ``conv2d_xla``, which dequantizes the
    residual and adds it after the bias."""
    g, feed = _one_conv(GEOMETRIES[name], out_scale=0.05 if out == "int8" else None,
                        act="relu", residual_scale=0.04, seed=30 + len(name))
    ref, got = _run_reference(g, feed), _run_port_cuda(g, feed)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if out == "int8":
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert d.max() <= testing.TIE_LSB
        assert (d > 0).sum() <= max(testing.TIE_COUNT, testing.TIE_FRACTION * d.size)
    else:
        np.testing.assert_allclose(got, ref, rtol=FP32_RTOL, atol=FP32_ATOL)


@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("out", ["int8", "fp32"])
def test_plain_residual_epilogue_vs_conv_epilogue(out, act):
    """``int8_matmul_plain`` with a residual against ``nn._conv_epilogue``'s
    arithmetic on the same exact accumulator: fp32 out bit for bit (the
    same steps in the same order), int8 out within the tie bound (the
    GEMM requantizes with ``y·fp32(1/s)``, the epilogue with ``y / s``)."""
    from paddle_lite_tpu_torch.core.executor import ExecutionContext
    from paddle_lite_tpu_torch.ops.nn import _conv_epilogue, eff_scale

    g, conv = _conv_graph(k=1, residual="int8", **({"act": act} if act else {}))
    g.vars[conv.input("Input")].quant = QuantInfo.per_tensor(0.02)
    g.vars[conv.input("Filter")].quant = QuantInfo(
        scale=tuple(float(v) for v in np.random.default_rng(5).uniform(5e-4, 2e-3, 16)),
        axis=3)
    if out == "int8":
        conv.attrs["out_scale"] = 0.05
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-127, 128, size=(64, 16), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(16, 16), dtype=np.int8))
    r = torch.from_numpy(rng.integers(-127, 128, size=(64, 16), dtype=np.int8))
    bias = torch.from_numpy(rng.normal(0, 0.3, size=16).astype(np.float32))
    ctx = ExecutionContext(graph=g, device=CPU)
    eff = eff_scale(ctx, conv, conv.input("Input"), conv.input("Filter"))
    acc = (x.double() @ w.double()).float()
    want = _conv_epilogue(ctx, conv, acc, conv.input("Input"), conv.input("Filter"), bias,
                          r, "r", int8_acc=True)
    got = int8_matmul.int8_matmul_plain(
        x, w, eff, bias, act=act, out_scale=conv.attrs.get("out_scale"), residual=r,
        residual_scale=g.vars["r"].quant.scale[0])
    assert got.dtype == want.dtype
    if out == "fp32":
        assert torch.equal(got, want)
    else:
        d = (got.int() - want.int()).abs()
        assert d.max() <= testing.TIE_LSB
        assert (d > 0).sum() <= max(testing.TIE_COUNT, testing.TIE_FRACTION * d.numel())


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_unit_scale_output_is_the_int32_accumulator(name):
    geom = GEOMETRIES[name]
    g, feed = _one_conv(geom, x_scale=1.0, w_scales=np.ones(geom[7]), bias=False,
                        act=None, seed=7)
    acc = _int32_acc(feed["x"], np.asarray(g.weights["w"]), geom[5], geom[6])
    got = _run_port_cuda(g, feed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, acc.astype(np.float32))


def test_saturating_k4608_is_exact():
    """x and w of one sign in 100..127 at C = 512 (K = 4608): the accumulator
    passes 2^24, where an fp32 conv has no exactness guarantee; the route
    still gives the int32 accumulator rounded once to fp32."""
    geom = (1, 5, 5, 512, 3, 1, [1, 1], 8)
    rng = np.random.default_rng(11)
    x = rng.integers(100, 128, size=geom[:4], dtype=np.int8)
    w = rng.integers(100, 128, size=(3, 3, 512, 8), dtype=np.int8)
    g, feed = _one_conv(geom, x_scale=1.0, w_scales=np.ones(8), bias=False, act=None,
                        x=x, w=w)
    acc = _int32_acc(x, w, 1, [1, 1])
    assert acc.max() > 2 ** 24
    got = _run_port_cuda(g, feed)
    np.testing.assert_array_equal(got, acc.astype(np.float32))


# ---- im2col_nhwc ------------------------------------------------------------

def _im2col_loop(x: np.ndarray, k: int, s: int, pads) -> np.ndarray:
    (pt, pb), (pl, pr) = _pad_pairs(pads)
    xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    n, hp, wp, _ = xp.shape
    oh, ow = (hp - k) // s + 1, (wp - k) // s + 1
    rows = []
    for b in range(n):
        for oy in range(oh):
            for ox in range(ow):
                rows.append(np.concatenate([xp[b, oy * s + i, ox * s + j]
                                            for i in range(k) for j in range(k)]))
    return np.stack(rows)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_im2col_column_order_matches_a_loop(name):
    n, h, w, c, k, s, pads, _ = GEOMETRIES[name]
    x = np.random.default_rng(3).integers(-127, 128, size=(n, h, w, c), dtype=np.int8)
    got = im2col_nhwc(torch.from_numpy(x), k, k, [s, s], pads)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), _im2col_loop(x, k, s, pads))


def test_im2col_of_a_1x1_stride_1_conv_is_a_view():
    x = torch.zeros((2, 4, 4, 8), dtype=torch.int8)
    assert im2col_nhwc(x, 1, 1, [1, 1], [0, 0]).data_ptr() == x.data_ptr()


# ---- which convs the GEMM takes ---------------------------------------------

def _conv_graph(**kw):
    """One conv2d in a port graph, marked int8 unless ``int8=False``; with
    ``residual="int8"`` / ``"fp32"`` a residual input of its output's shape,
    int8 at a per-tensor scale or fp32."""
    c, k = kw.pop("c", 16), kw.pop("k", 3)
    int8 = kw.pop("int8", True)
    residual = kw.pop("residual", None)
    b = GraphBuilder("t", seed=0)
    x = b.input("x", (1, 8, 8, c))
    b.conv2d(x, 16, k, stride=kw.get("stride", 1), padding=k // 2,
             groups=kw.get("groups", 1), dilation=kw.get("dilation", 1))
    g = b.build()
    conv = next(o for o in g.ops if o.op_type == "conv2d")
    conv.attrs["enable_int8"] = int8
    if "act" in kw:
        conv.attrs["fuse_act"] = kw["act"]
    if residual:
        r = g.add_var("r", g.vars[conv.output("Output")].shape,
                      Precision.INT8 if residual == "int8" else Precision.FP32)
        if residual == "int8":
            r.quant = QuantInfo.per_tensor(0.05)
        conv.inputs["ResidualData"] = ["r"]
    return g, conv


@pytest.mark.parametrize("case,kw,ok", [
    ("3x3_s2", dict(stride=2), True),
    ("7x7", dict(k=7, c=4), True),
    ("1x1", dict(k=1), True),
    ("relu6", dict(act="relu6"), True),
    ("residual", dict(residual="int8"), True),  # the GEMM's epilogue adds it
    ("residual_fp32", dict(residual="fp32"), False),
    ("grouped", dict(groups=2), False),
    ("dilated", dict(dilation=2), False),
    ("odd_k", dict(c=3), False),          # K = 27
    ("fp32", dict(int8=False), False),
    ("sigmoid", dict(act="sigmoid"), False),  # not in the kernels' epilogue
])
def test_gemm_eligible(case, kw, ok):
    g, conv = _conv_graph(**kw)
    assert gemm_eligible(g, conv) is ok
    assert choose_kernel(g, conv) == ("cuda" if ok else None)


@pytest.mark.parametrize("attrs,ins,match", [
    ({"groups": 2}, {}, "group-1"),
    ({"dilations": [2, 2]}, {}, "dilation-1"),
    ({}, {"ResidualData": True}, "residual"),
])
def test_cuda_conv_raises_instead_of_falling_back(attrs, ins, match):
    from paddle_lite_tpu_torch.core.executor import ExecutionContext
    from paddle_lite_tpu_torch.core.registry import OPS

    g, conv = _conv_graph()
    conv.attrs.update(attrs)
    x = torch.zeros((1, 8, 8, 16), dtype=torch.int8)
    feed = {"Input": [x], "Filter": [torch.zeros((3, 3, 16, 16), dtype=torch.int8)]}
    if ins:  # a float residual: only an int8 one goes into the GEMM's epilogue
        feed["ResidualData"] = [x.float()]
    with pytest.raises(ValueError, match=match):
        OPS.get("conv2d").impls["cuda"](ExecutionContext(graph=g, device=CPU), conv, feed)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the GEMM kernel has no CPU mode); "
                    "python3 chip_smoke.py runs the route on the card")
    return torch.device("cuda")


def test_route_on_card_is_the_exact_accumulator(cuda_device):
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(100, 128, size=(2, 7, 7, 512), dtype=np.int8))
    w = torch.from_numpy(rng.integers(100, 128, size=(3, 3, 512, 64), dtype=np.int8))
    cols = im2col_nhwc(x.to(cuda_device), 3, 3, [1, 1], [1, 1])
    ones = torch.ones(64, device=cuda_device)
    got = int8_matmul.int8_matmul(cols, w.reshape(-1, 64).to(cuda_device), ones)
    want = int8_matmul.int8_matmul_plain(cols, w.reshape(-1, 64).to(cuda_device), ones)
    assert torch.equal(got, want)


def _residual_shapes(path: str):
    """(M, K, N, act) of each distinct residual conv of ResNet-50 b32 or
    MobileNetV3 b64 at 224 px, read off the graph after the fusion passes."""
    from paddle_lite_tpu_torch.core.pass_manager import PassManager
    from paddle_lite_tpu_torch.models import mobilenet_v3, resnet
    from paddle_lite_tpu_torch.tools.opt import FUSION_PASSES

    g = (resnet.build(batch=32, image_size=224, seed=0) if path == "resnet"
         else mobilenet_v3.build(batch=64, image_size=224, seed=0, with_softmax=False))
    PassManager(FUSION_PASSES).run(g)
    shapes = []
    for op in g.topological_order():
        if op.op_type == "conv2d" and op.maybe_input("ResidualData"):
            n, oh, ow, oc = g.vars[op.output("Output")].shape
            shapes.append((n * oh * ow, int(np.prod(g.vars[op.input("Filter")].shape[:3])),
                           oc, op.attrs.get("fuse_act")))
    assert len(shapes) == (16 if path == "resnet" else 10)
    return sorted(set(shapes), key=str)


@pytest.mark.parametrize("out", ["int8", "fp32"])
@pytest.mark.parametrize("path", ["resnet", "mobilenet_v3"])
def test_residual_gemm_on_card_vs_plain(cuda_device, path, out):
    """The kernel's residual instantiation at every residual shape of the
    path, bit for bit against ``int8_matmul_plain``."""
    rng = np.random.default_rng(25)

    def i8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, size=shape, dtype=np.int8)).to(cuda_device)

    for m, k, n, act in _residual_shapes(path):
        x, w, r = i8(m, k), i8(k, n), i8(m, n)
        eff = torch.from_numpy(rng.uniform(1e-4, 2e-4, n).astype(np.float32)).to(cuda_device)
        bias = torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(cuda_device)
        kw = dict(act=act, residual=r, residual_scale=0.03)
        if out == "int8":
            y = int8_matmul.int8_matmul_plain(x, w, eff, bias, **kw)
            kw["out_scale"] = float(y.abs().max()) / 127 * 0.75
        before = int8_matmul.launches_residual
        got = int8_matmul.int8_matmul(x, w, eff, bias, **kw)
        assert int8_matmul.launches_residual == before + 1
        assert torch.equal(got, int8_matmul.int8_matmul_plain(x, w, eff, bias, **kw)), (m, k, n)


@pytest.mark.parametrize("geom", [(32, 56, 64, 256, "relu"), (64, 14, 480, 112, None)])
def test_residual_route_on_card_takes_a_sliced_residual(cuda_device, geom):
    """The "cuda" conv given a residual sliced on its channel axis (as
    ``ShardedPredictor`` hands it): the kernel's output equals the route's
    plain version on the CPU bit for bit, and the "torch" conv within the
    tie bound."""
    from paddle_lite_tpu_torch.core.executor import ExecutionContext
    from paddle_lite_tpu_torch.core.registry import OPS

    nb, h, c, oc, act = geom
    rng = np.random.default_rng(7)
    b = GraphBuilder("t", seed=0)
    b.conv2d(b.input("x", (nb, h, h, c)), oc, 1, stride=1, padding=0)
    g = b.build()
    conv = next(o for o in g.ops if o.op_type == "conv2d")
    g.vars[conv.input("Input")].quant = QuantInfo.per_tensor(0.02)
    g.vars[conv.input("Filter")].quant = QuantInfo(
        scale=tuple(float(v) for v in rng.uniform(5e-4, 2e-3, oc)), axis=3)
    g.add_var("r", g.vars[conv.output("Output")].shape, Precision.INT8).quant = \
        QuantInfo.per_tensor(0.04)
    conv.inputs["ResidualData"] = ["r"]
    conv.attrs.update(enable_int8=True, out_scale=0.05, **({"fuse_act": act} if act else {}))
    x = torch.from_numpy(rng.integers(-127, 128, (nb, h, h, c), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (1, 1, c, oc), dtype=np.int8))
    wide = torch.from_numpy(rng.integers(-127, 128, (nb, h, h, 2 * oc), dtype=np.int8))
    ins = {"Input": [x], "Filter": [w], "ResidualData": [wide[..., oc // 2: oc // 2 + oc]]}
    on_card = {s: [t.to(cuda_device) for t in v] for s, v in ins.items()}
    assert not on_card["ResidualData"][0].is_contiguous()
    conv2d = OPS.get("conv2d")
    card_ctx = ExecutionContext(graph=g, device=cuda_device)
    got = conv2d.impls["cuda"](card_ctx, conv, on_card)["Output"][0].cpu()
    plain = conv2d.impls["cuda"](ExecutionContext(graph=g, device=CPU), conv, ins)["Output"][0]
    assert torch.equal(got, plain)
    ref = conv2d.impls["torch"](card_ctx, conv, on_card)["Output"][0].cpu()
    d = (got.int() - ref.int()).abs()
    assert d.max() <= testing.TIE_LSB
    assert (d > 0).sum() <= max(testing.TIE_COUNT, testing.TIE_FRACTION * d.numel())
