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
              out_scale=None, x=None, w=None, seed=0):
    """A reference graph holding one int8 conv2d, and its feed."""
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
    g.outputs.append("y")
    g.add_op("conv2d", ins, {"Output": ["y"]}, attrs)
    g.rebuild_links()
    if x is None:
        x = rng.integers(-127, 128, size=(n, h, wd, c), dtype=np.int8)
    return g, {"x": x}


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
    """One conv2d in a port graph, marked int8 unless ``int8=False``."""
    c, k = kw.pop("c", 16), kw.pop("k", 3)
    int8 = kw.pop("int8", True)
    residual = kw.pop("residual", False)
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
        conv.inputs["ResidualData"] = [x]
    return g, conv


@pytest.mark.parametrize("case,kw,ok", [
    ("3x3_s2", dict(stride=2), True),
    ("7x7", dict(k=7, c=4), True),
    ("1x1", dict(k=1), True),
    ("relu6", dict(act="relu6"), True),
    ("residual", dict(residual=True), False),
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
    if ins:
        feed["ResidualData"] = [x]
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
