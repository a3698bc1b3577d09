"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference kernels run in Pallas interpret mode, as tests/test_pallas_kernels.py
runs them.  Both implement the same epilogue (y·fp32(1/out_scale), rounded
half to even), so int8 outputs must match exactly.  fp32 outputs are held to
rtol 1e-6: XLA on the CPU may contract ``acc·scale + bias`` into one FMA
where the port rounds twice, one ulp apart.  The CUDA kernels themselves are
compared with these plain versions by ``chip_smoke.py`` on the card, and by
the tests at the end of this file where a card is present.
"""

import numpy as np
import pytest
import torch

from paddle_lite_tpu.ops.kernels import depthwise as r_dw
from paddle_lite_tpu.ops.kernels.int8_matmul import int8_matmul as r_int8_matmul
from paddle_lite_tpu_torch.ops.kernels import depthwise as p_dw
from paddle_lite_tpu_torch.ops.kernels import int8_matmul as p_mm

FP32_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gemm_problem(rng, m, k, n):
    x = rng.integers(-127, 128, size=(m, k), dtype=np.int8)
    w = rng.integers(-127, 128, size=(k, n), dtype=np.int8)
    eff = rng.uniform(1e-4, 2e-4, size=(n,)).astype(np.float32)
    bias = rng.normal(0, 0.5, size=(n,)).astype(np.float32)
    return x, w, eff, bias


def _out_scale(y):
    return float(np.abs(np.asarray(y)).max()) / 127 * 0.75


def _check(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype == np.int8:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=FP32_RTOL, atol=1e-6)


@pytest.mark.parametrize("m,k,n", [
    (64, 32, 64),       # K=32: the first pointwise layer's depth
    (128, 128, 96),
    (100, 96, 60),      # ragged M, N
    (8, 1024, 1000),    # the classifier (N=1000)
])
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("int8_out", [True, False])
def test_int8_matmul_plain_vs_pallas(m, k, n, act, int8_out):
    rng = np.random.default_rng(m * 7 + k + n)
    x, w, eff, bias = _gemm_problem(rng, m, k, n)
    out_scale = None
    if int8_out:
        out_scale = _out_scale(r_int8_matmul(x, w, eff, bias, act=act,
                                             interpret=True))
    ref = r_int8_matmul(x, w, eff, bias, act=act, out_scale=out_scale,
                        interpret=True)
    got = p_mm.int8_matmul(_t(x), _t(w), _t(eff), _t(bias), act=act,
                           out_scale=out_scale)
    _check(got, ref)


def test_int8_matmul_no_bias_scalar_scale():
    rng = np.random.default_rng(1)
    x, w, _, _ = _gemm_problem(rng, 32, 64, 48)
    ref = r_int8_matmul(x, w, np.float32(1e-3), None, out_scale=0.05,
                        interpret=True)
    got = p_mm.int8_matmul(_t(x), _t(w), 1e-3, None, out_scale=0.05)
    _check(got, ref)


def test_int8_matmul_accumulator_exact():
    """Unit scale, no bias, fp32 out: the int32 accumulator itself."""
    rng = np.random.default_rng(2)
    x, w, _, _ = _gemm_problem(rng, 16, 1024, 24)
    got = p_mm.int8_matmul(_t(x), _t(w), torch.ones(24)).numpy()
    np.testing.assert_array_equal(got, (x.astype(np.int64) @ w).astype(np.float32))


def test_reciprocal_is_rounded_from_double():
    # the Pallas epilogue applies float32(1.0 / out_scale) computed in
    # double; an fp32 reciprocal differs for many scales, and the wrapper
    # must not use it
    s = [float(v) for v in np.random.default_rng(3).uniform(1e-3, 1.0, 2000)]
    assert all(p_mm.inv_out_scale(v) == float(np.float32(1.0 / v)) for v in s)
    fp32_recip = [float(np.float32(1.0) / np.float32(v)) for v in s]
    assert any(a != p_mm.inv_out_scale(v) for a, v in zip(fp32_recip, s))


def test_epilogue_rejects_unported_activation():
    assert p_mm.act_code("relu6") == 2
    assert p_mm.act_args("hard_swish", {"scale": 6}) == (4, 6.0, 6.0, 3.0)
    assert p_mm.act_args("hard_sigmoid", {"slope": 0.2})[:2] == (5, float(np.float32(0.2)))
    with pytest.raises(NotImplementedError, match="sigmoid"):
        p_mm.act_code("sigmoid")


def _dw_problem(rng, n, h, w, c, k):
    x = rng.integers(-127, 128, size=(n, h, w, c), dtype=np.int8)
    wt = rng.integers(-127, 128, size=(k, k, 1, c), dtype=np.int8)
    eff = rng.uniform(1e-3, 2e-3, size=(c,)).astype(np.float32)
    bias = rng.normal(0, 0.5, size=(c,)).astype(np.float32)
    return x, wt, eff, bias


@pytest.mark.parametrize("n,h,w,c,k,s", [
    (2, 16, 16, 32, 3, 1),
    (2, 16, 16, 64, 3, 2),
    (1, 15, 13, 24, 3, 2),   # odd spatial sizes
    (2, 12, 12, 40, 5, 1),
    (2, 13, 11, 16, 5, 2),
    (1, 9, 9, 30, 3, 1),     # ragged C (not a multiple of 4)
])
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("int8_out", [True, False])
def test_dw_conv_plain_vs_pallas(n, h, w, c, k, s, act, int8_out):
    rng = np.random.default_rng(n + h * 3 + c + k + s)
    x, wt, eff, bias = _dw_problem(rng, n, h, w, c, k)
    out_scale = None
    if int8_out:
        out_scale = _out_scale(r_dw.dw_conv_int8(x, wt, eff, bias, stride=s,
                                                 act=act, interpret=True))
    ref = r_dw.dw_conv_int8(x, wt, eff, bias, stride=s, act=act,
                            out_scale=out_scale, interpret=True)
    got = p_dw.dw_conv_int8(_t(x), _t(wt), _t(eff), _t(bias), stride=s,
                            act=act, out_scale=out_scale)
    _check(got, ref)


def test_dw_conv3x3s1_plain_vs_pallas():
    rng = np.random.default_rng(5)
    x, wt, eff, bias = _dw_problem(rng, 4, 8, 8, 48, 3)
    ref = r_dw.dw_conv3x3s1_int8(x, wt, eff, bias, act="relu", out_scale=0.04,
                                 interpret=True)
    got = p_dw.dw_conv3x3s1_int8(_t(x), _t(wt), _t(eff), _t(bias), act="relu",
                                 out_scale=0.04)
    _check(got, ref)
    with pytest.raises(ValueError, match="3, 3, 1"):
        p_dw.dw_conv3x3s1_int8(_t(x), _t(rng.integers(-9, 9, (5, 5, 1, 48),
                                                      dtype=np.int8)), eff)


@pytest.mark.parametrize("attrs,x_shape,w_shape,ok", [
    ({"strides": [1, 1], "paddings": [1, 1]}, (1, 8, 8, 16), (3, 3, 1, 16), True),
    ({"strides": [2, 2], "paddings": [2, 2]}, (1, 8, 8, 16), (5, 5, 1, 16), True),
    # far above the TPU's 9 MB VMEM slab cap: still eligible here
    ({"strides": [1, 1], "paddings": [1, 1]}, (1, 320, 320, 64), (3, 3, 1, 64), True),
    ({"strides": [1, 1], "paddings": [0, 0]}, (1, 8, 8, 16), (3, 3, 1, 16), False),
    ({"strides": [1, 2], "paddings": [1, 1]}, (1, 8, 8, 16), (3, 3, 1, 16), False),
    ({"strides": [1, 1], "paddings": [3, 3]}, (1, 8, 8, 16), (7, 7, 1, 16), False),
    ({"strides": [1, 1], "paddings": [1, 1], "dilations": [2, 2]},
     (1, 8, 8, 16), (3, 3, 1, 16), False),
    ({"strides": [1, 1], "paddings": [1, 1]}, (1, 8, 8, 16), (3, 3, 1, 32), False),
])
def test_dw_supported_general_semantics(attrs, x_shape, w_shape, ok):
    assert p_dw.supported_general(attrs, x_shape, w_shape) is ok
    if x_shape[1] < 100:  # the reference agrees wherever its slab cap allows
        assert r_dw.supported_general(attrs, x_shape, w_shape) is ok


# ---- on the card: the CUDA kernels against their plain versions -----------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "python3 chip_smoke.py runs the full check on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [
    (1000, 96, 200), (333, 40, 70), (64, 1024, 1000),
    # the redesigned kernel's edges: K = 16, 18, 24, 30 (2-, 8- and 16-byte
    # copies) and 2048; N = 18, 30, 1280; M = 1, 63, 65
    (64, 16, 64), (64, 18, 72), (200, 24, 72), (100, 30, 120), (64, 2048, 256),
    (500, 64, 18), (500, 64, 30), (63, 512, 1280), (1, 128, 64), (65, 72, 130)])
def test_int8_gemm_kernel_vs_plain_on_card(cuda_device, m, k, n):
    rng = np.random.default_rng(0)
    x, w, eff, bias = (_t(a).to(cuda_device) for a in _gemm_problem(rng, m, k, n))
    for out_scale in (None, 0.05):
        got = p_mm.int8_matmul(x, w, eff, bias, act="relu", out_scale=out_scale)
        ref = p_mm.int8_matmul_plain(x, w, eff, bias, act="relu",
                                     out_scale=out_scale)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(2, 16, 16, 32, 3, 1), (2, 13, 11, 30, 5, 2)])
def test_dw_kernel_vs_plain_on_card(cuda_device, shape):
    n, h, w, c, k, s = shape
    rng = np.random.default_rng(0)
    x, wt, eff, bias = (_t(a).to(cuda_device) for a in _dw_problem(rng, n, h, w, c, k))
    for out_scale in (None, 0.05):
        got = p_dw.dw_conv_int8(x, wt, eff, bias, stride=s, act="relu6",
                                out_scale=out_scale)
        ref = p_dw.dw_conv_int8_plain(x, wt, eff, bias, stride=s, act="relu6",
                                      out_scale=out_scale)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("act,tag", [("relu", "cuda"), ("relu6", "cuda"),
                                     (None, "cuda"), ("hard_swish", "cuda"),
                                     ("hard_sigmoid", "cuda"), ("leaky_relu", "cuda"),
                                     ("sigmoid", None), ("swish", None)])
def test_kernel_pick_only_what_the_epilogue_computes(act, tag):
    from paddle_lite_tpu_torch.core.ir import Graph
    from paddle_lite_tpu_torch.ops.kernels.select import choose_kernel

    g = Graph("t")
    g.add_var("x", (1, 4, 4, 8))
    g.add_weight("w", np.zeros((1, 1, 8, 8), np.int8))
    g.add_weight("dw", np.zeros((3, 3, 1, 8), np.int8))
    g.add_var("y", (1, 4, 4, 8))
    g.add_var("z", (1, 4, 4, 8))
    attrs = {"enable_int8": True, "strides": [1, 1], "paddings": [0, 0]}
    if act:
        attrs["fuse_act"] = act
    pw = g.add_op("conv2d", {"Input": ["x"], "Filter": ["w"]}, {"Output": ["y"]}, attrs)
    dw = g.add_op("depthwise_conv2d", {"Input": ["y"], "Filter": ["dw"]},
                  {"Output": ["z"]}, dict(attrs, paddings=[1, 1]))
    assert choose_kernel(g, pw) == tag and choose_kernel(g, dw) == tag
    pw.attrs["enable_int8"] = False
    assert choose_kernel(g, pw) is None
