"""The int8 GEMM's gathering launch: a conv's im2col rows read inside the
GEMM (``int8_matmul.int8_conv``, ``csrc/int8_gemm_conv.cu``) instead of
made by ``im2col_nhwc``.

On the CPU: :func:`gather_map`, the kernel's index arithmetic step for
step (its divisions by multiplication too), held element for element to
``im2col_nhwc`` at every conv geometry that gathers on the ResNet-50, SSD
and DBNet paths (MobileNetV3's, CRNN's and MobileNetV1's only k×k convs
are their odd-C stems, which the GEMM does not take; ERNIE has no conv) and
at edge cases; the divisions
against floor division; which path the ``"cuda"`` conv takes; the plan of a
gathering launch.  On the card (skipped here): each gathering launch
bit-exact against the dense launch over ``im2col_nhwc``'s rows, at
ResNet-50's 16 gathering convs, its 3 strided shortcuts and the edge cases,
and a whole ResNet-50 call bit-equal to the explicit rows'.  This file imports no JAX, so on the
card it runs without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_conv_gather.py -q
"""

import numpy as np
import pytest
import torch

from paddle_lite_tpu_torch.models import (ernie_tiny, mobilenet_v1, mobilenet_v3, ppocr,
                                          resnet, ssd)
from paddle_lite_tpu_torch.ops.kernels import custom_ops, int8_matmul as km, tune_cache
from paddle_lite_tpu_torch.ops.kernels.ops_cuda import im2col_nhwc
from paddle_lite_tpu_torch.ops.kernels.select import gemm_eligible

CPU = torch.device("cpu")


# ---- the kernel's index arithmetic, in Python --------------------------------

def fast_div(d: int):
    """(mul, shift) of ``FastDiv`` in ``csrc/int8_gemm.cuh``: for 0 <= x <
    2^31, x // d = (mulhi32(x, mul) + x) >> shift, with shift = ceil(log2
    d) and mul = floor(2^32 (2^shift - d) / d) + 1."""
    s = (d - 1).bit_length()
    return (((1 << s) - d) << 32) // d + 1, s


def _div(x: np.ndarray, d: int) -> np.ndarray:
    """x // d as ``FastDiv::div`` computes it, on int64 arrays of values in
    [0, 2^31)."""
    mul, s = fast_div(d)
    u = x.astype(np.uint64)
    return ((((u * np.uint64(mul)) >> np.uint64(32)) + u) >> np.uint64(s)).astype(np.int64)


def gather_map(g: km.ConvGeom, width: int, rows: int, cols: int) -> np.ndarray:
    """Where a gathering launch reads each piece, as ``copy_slab_conv``
    works it out, step for step: for row r < `rows` and byte k < `cols` of
    the im2col rows, k a multiple of `width`, the offset in x's bytes of
    the piece's first byte, or -1 where the piece is zero-filled (a tap in
    the padding, r past M, k past K).  `rows` and `cols` may run past M
    and K, as a tile's do."""
    r = np.arange(rows, dtype=np.int64)[:, None]
    k = np.arange(0, cols, width, dtype=np.int64)[None, :]
    tap = _div(k, g.c)
    c = k - tap * g.c
    i = _div(tap, g.kw)
    di, dj = i - g.pt, tap - i * g.kw - g.pl
    q = _div(r, g.ow)
    n = _div(q, g.oh)
    ih, iw = (q - n * g.oh) * g.sh + di, (r - q * g.ow) * g.sw + dj
    inside = (k < g.k) & (r < g.m) & (ih >= 0) & (ih < g.h) & (iw >= 0) & (iw < g.w)
    return np.where(inside, ((n * g.h + ih) * g.w + iw) * g.c + c, -1)

# the convs that gather on each path, per image: (H, W, C, kh, kw, sh, sw,
# (pt, pb, pl, pr), OC) -> convs a request; read off the graphs after the
# fusion passes at the sizes the cells and chip_smoke.py run (ResNet-50 224
# px, SSD 300 px, DBNet 640 px, MobileNetV3 224 px, CRNN 32 x 320,
# MobileNetV1 224 px, ERNIE-tiny 128 tokens: the last two cells' models,
# whose GEMM launches stay dense)
PATH_CONVS = {
    "resnet": {
        (56, 56, 64, 3, 3, 1, 1, (1, 1, 1, 1), 64): 3,
        (56, 56, 128, 3, 3, 2, 2, (1, 1, 1, 1), 128): 1,
        (28, 28, 128, 3, 3, 1, 1, (1, 1, 1, 1), 128): 3,
        (28, 28, 256, 3, 3, 2, 2, (1, 1, 1, 1), 256): 1,
        (14, 14, 256, 3, 3, 1, 1, (1, 1, 1, 1), 256): 5,
        (14, 14, 512, 3, 3, 2, 2, (1, 1, 1, 1), 512): 1,
        (7, 7, 512, 3, 3, 1, 1, (1, 1, 1, 1), 512): 2,
    },
    "ssd": {
        (19, 19, 512, 3, 3, 1, 1, (1, 1, 1, 1), 16): 1,
        (19, 19, 512, 3, 3, 1, 1, (1, 1, 1, 1), 84): 1,
        (10, 10, 1024, 3, 3, 1, 1, (1, 1, 1, 1), 24): 1,
        (10, 10, 1024, 3, 3, 1, 1, (1, 1, 1, 1), 126): 1,
        (10, 10, 256, 3, 3, 2, 2, (1, 1, 1, 1), 512): 1,
        (5, 5, 512, 3, 3, 1, 1, (1, 1, 1, 1), 24): 1,
        (5, 5, 512, 3, 3, 1, 1, (1, 1, 1, 1), 126): 1,
        (5, 5, 128, 3, 3, 2, 2, (1, 1, 1, 1), 256): 1,
        (3, 3, 256, 3, 3, 1, 1, (1, 1, 1, 1), 24): 1,
        (3, 3, 256, 3, 3, 1, 1, (1, 1, 1, 1), 126): 1,
        (3, 3, 128, 3, 3, 2, 2, (1, 1, 1, 1), 256): 1,
        (2, 2, 256, 3, 3, 1, 1, (1, 1, 1, 1), 24): 1,
        (2, 2, 256, 3, 3, 1, 1, (1, 1, 1, 1), 126): 1,
        (2, 2, 64, 3, 3, 2, 2, (1, 1, 1, 1), 128): 1,
        (1, 1, 128, 3, 3, 1, 1, (1, 1, 1, 1), 24): 1,
        (1, 1, 128, 3, 3, 1, 1, (1, 1, 1, 1), 126): 1,
    },
    "dbnet": {
        (20, 20, 96, 3, 3, 1, 1, (1, 1, 1, 1), 24): 1,
        (40, 40, 96, 3, 3, 1, 1, (1, 1, 1, 1), 24): 1,
        (80, 80, 96, 3, 3, 1, 1, (1, 1, 1, 1), 24): 1,
        (160, 160, 96, 3, 3, 1, 1, (1, 1, 1, 1), 24): 2,
    },
    "mobilenet_v3": {},
    "crnn": {},
    "mobilenet_v1": {},
    "ernie_tiny": {},
}
GRAPHS = {
    "resnet": lambda: resnet.build(batch=1, image_size=224, seed=0),
    "ssd": lambda: ssd.build(batch=1, image_size=300, num_classes=21, seed=0),
    "dbnet": lambda: ppocr.build_det(batch=1, image_size=640),
    "mobilenet_v3": lambda: mobilenet_v3.build(batch=1, image_size=224, seed=0,
                                               with_softmax=False),
    "crnn": lambda: ppocr.build_rec(batch=1, width=320),
    "mobilenet_v1": lambda: mobilenet_v1.build(batch=1, image_size=224, seed=0),
    "ernie_tiny": lambda: ernie_tiny.build(batch=1, seq_len=128, hidden_act="relu"),
}

# ResNet-50's strided 1x1 shortcut convs, which carry their block's residual
# (the fusion passes add it in there) and so keep the explicit rows on the
# path: the gather at their shapes all the same
R50_STRIDED = {
    "resnet_56x56x256_k1s2_oc512": (32, 56, 56, 256, 1, 1, 2, 2, (0, 0, 0, 0), 512),
    "resnet_28x28x512_k1s2_oc1024": (32, 28, 28, 512, 1, 1, 2, 2, (0, 0, 0, 0), 1024),
    "resnet_14x14x1024_k1s2_oc2048": (32, 14, 14, 1024, 1, 1, 2, 2, (0, 0, 0, 0), 2048),
}

# name: (N, H, W, C, kh, kw, sh, sw, (pt, pb, pl, pr), OC); pieces of 16, 8,
# 4 and 2 bytes, asymmetric paddings, stride 2 on an odd H or W, a padded
# and a strided 1x1, a window that is not square, M tails off the tile
EDGES = {
    "c2_3x3_s1_p1": (2, 7, 9, 2, 3, 3, 1, 1, (1, 1, 1, 1), 24),
    "c2_2x2_s1": (3, 5, 6, 2, 2, 2, 1, 1, (0, 0, 0, 0), 16),
    "c6_3x1_s1_p1_0": (2, 8, 5, 6, 3, 1, 1, 1, (1, 1, 0, 0), 40),
    "c4_3x3_s2_p1_odd_hw": (2, 9, 11, 4, 3, 3, 2, 2, (1, 1, 1, 1), 8),
    "c8_5x5_s1_p2": (1, 10, 10, 8, 5, 5, 1, 1, (2, 2, 2, 2), 130),
    "c16_3x3_s2_pads_0101": (2, 10, 10, 16, 3, 3, 2, 2, (0, 1, 0, 1), 24),
    "c24_3x3_s2_pads_1021": (3, 13, 12, 24, 3, 3, 2, 2, (1, 0, 2, 1), 72),
    "c32_3x3_s1_p1_m35": (1, 5, 7, 32, 3, 3, 1, 1, (1, 1, 1, 1), 64),
    "c64_7x7_s2_p3": (1, 15, 15, 64, 7, 7, 2, 2, (3, 3, 3, 3), 32),
    "c96_1x1_s1_p1": (1, 5, 5, 96, 1, 1, 1, 1, (1, 1, 1, 1), 48),
    "c128_1x1_s2_odd_hw": (2, 9, 9, 128, 1, 1, 2, 2, (0, 0, 0, 0), 256),
    "c512_3x3_s1_p1_k4608": (2, 3, 3, 512, 3, 3, 1, 1, (1, 1, 1, 1), 8),
}


def _path_cases(batch: int) -> dict:
    return {f"{p}_{'x'.join(map(str, k[:3]))}_k{k[3]}s{k[5]}_oc{k[8]}": (batch,) + k
            for p, convs in PATH_CONVS.items() for k in convs}


def _geom(case) -> km.ConvGeom:
    n, h, w, c, kh, kw, sh, sw, pads, _ = case
    return km.conv_geom((n, h, w, c), kh, kw, (sh, sw), pads)


def _i8(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(-127, 128, size=shape, dtype=np.int8))


# ---- the gather's index arithmetic, on the CPU --------------------------------

def test_path_convs_are_the_graphs():
    """The table above is what the five graphs route to the gathering
    launch: every int8 conv the GEMM takes with no residual whose rows are
    no view of its input, and whose C is even.  (A conv with a residual is
    not eligible before quantization makes the residual int8.)"""
    from paddle_lite_tpu_torch.core.pass_manager import PassManager
    from paddle_lite_tpu_torch.tools.opt import FUSION_PASSES

    strided = {k[1:] for k in R50_STRIDED.values()}
    for path, build in GRAPHS.items():
        g = build()
        PassManager(FUSION_PASSES).run(g)
        seen = {}
        for op in g.topological_order():
            if op.op_type != "conv2d":
                continue
            op.attrs["enable_int8"] = True
            if path == "resnet" and op.maybe_input("ResidualData"):
                _, h, w, c = g.vars[op.input("Input")].shape
                kh, kw, _, oc = g.vars[op.input("Filter")].shape
                strided.discard((h, w, c, kh, kw, *op.attrs["strides"],
                                 (0, 0, 0, 0), oc))
            if not gemm_eligible(g, op):
                continue
            _, h, w, c = g.vars[op.input("Input")].shape
            kh, kw, _, oc = g.vars[op.input("Filter")].shape
            geom = km.conv_geom((1, h, w, c), kh, kw, op.attrs.get("strides", (1, 1)),
                                op.attrs.get("paddings", (0, 0)))
            if km.gathers(geom):
                key = (h, w, c, kh, kw, geom.sh, geom.sw,
                       (geom.pt, geom.pb, geom.pl, geom.pr), oc)
                seen[key] = seen.get(key, 0) + 1
        assert seen == PATH_CONVS[path], path
    assert sum(PATH_CONVS["resnet"].values()) == 16  # its 3x3 convs
    assert not strided  # the strided shortcuts carry a residual


@pytest.mark.parametrize("name,case", sorted({**_path_cases(2), **EDGES}.items()))
def test_gather_map_is_im2col(name, case):
    """Every piece of every row and slab a gathering launch reads, past M
    and K as its last tile's are, equals ``im2col_nhwc``'s rows, and a
    piece never straddles two taps; at the widths 16, 8, 4, 2 that divide
    C, and at each slab depth."""
    g = _geom(case)
    x = _i8(np.random.default_rng(len(name)), g.n, g.h, g.w, g.c)
    want = im2col_nhwc(x, g.kh, g.kw, (g.sh, g.sw), (g.pt, g.pb, g.pl, g.pr)).numpy()
    assert want.shape == (g.m, g.k)
    flat = x.numpy().reshape(-1)
    widest = km.copy_width(g.c)
    for width in {widest, 2}:
        for bk in (32, 128):
            rows, cols = -(-g.m // 128) * 128, -(-g.k // bk) * bk
            src = gather_map(g, width, rows, cols)
            inside = src >= 0
            assert ((src[inside] % g.c) + width <= g.c).all()
            got = np.where(inside[..., None],
                           flat[np.where(inside, src, 0)[..., None] + np.arange(width)], 0)
            full = np.zeros((rows, cols), np.int8)
            full[:g.m, :g.k] = want
            np.testing.assert_array_equal(got.reshape(rows, cols), full)


def test_fast_div_is_floor_division():
    """``FastDiv``'s (mul, shift) divide every numerator the kernel gives
    them (below 2^31) as floor division does."""
    rng = np.random.default_rng(0)
    ds = sorted(set(range(1, 300)) | {c for cs in PATH_CONVS.values() for k in cs
                                      for c in (k[0], k[1], k[2], k[4])}
                | {1024, 3072, 4608, 12544, 25600, 65535, 2 ** 20 + 7, 2 ** 30 + 1})
    for d in ds:
        top = (2 ** 31 - 1) // d * d
        near = [d * j + o for j in (1, 2, 3, 1000) for o in (-1, 0, 1)]
        x = np.concatenate([rng.integers(0, 2 ** 31, 2000), np.arange(min(4 * d, 1200)),
                            [v for v in near if v < 2 ** 31],
                            [2 ** 31 - 1, 2 ** 31 - 2, top, top - 1]]).astype(np.int64)
        np.testing.assert_array_equal(_div(x, d), x // d, err_msg=f"d={d}")
        mul, s = fast_div(d)
        assert 1 <= mul < 2 ** 32 and (1 << s) >= d and (s == 0 or (1 << (s - 1)) < d)


# ---- which path a conv takes ---------------------------------------------------

@pytest.mark.parametrize("case,gathers", [
    ((1, 8, 8, 16, 1, 1, 1, 1, (0, 0, 0, 0), 8), False),  # rows = x itself: dense
    ((1, 8, 8, 16, 3, 3, 1, 1, (1, 1, 1, 1), 8), True),
    ((1, 8, 8, 16, 3, 3, 1, 1, (0, 0, 0, 0), 8), True),   # k×k, unpadded
    ((1, 8, 8, 16, 1, 1, 2, 2, (0, 0, 0, 0), 8), True),   # strided 1x1
    ((1, 8, 8, 16, 1, 1, 1, 1, (0, 1, 0, 0), 8), True),   # padded 1x1
    ((1, 6, 6, 3, 2, 2, 1, 1, (0, 0, 0, 0), 8), False),   # odd C: explicit rows (K 12)
])
def test_route_takes_the_gather_by_geometry(monkeypatch, case, gathers):
    """The ``"cuda"`` conv gathers where its rows are no view of its input
    and C is even; a 1x1, stride-1, unpadded conv runs the dense launch on
    its input, and a conv of odd C (K even through an even kh·kw) on the
    explicit rows; a conv with a residual (``test_torch_conv_gemm.py``)
    too.  Either way the output is the plain explicit rows' (on the CPU)."""
    from paddle_lite_tpu_torch.core.builder import GraphBuilder
    from paddle_lite_tpu_torch.core.executor import ExecutionContext
    from paddle_lite_tpu_torch.core.registry import OPS
    from paddle_lite_tpu_torch.core.types import QuantInfo
    from paddle_lite_tpu_torch.ops.nn import eff_scale

    n, h, w, c, kh, kw, sh, sw, pads, oc = case
    g = _geom(case)
    assert km.gathers(g) is gathers
    b = GraphBuilder("t", seed=0)
    b.conv2d(b.input("x", (n, h, w, c)), oc, kh, stride=sh, padding=0)
    graph = b.build()
    conv = next(o for o in graph.ops if o.op_type == "conv2d")
    conv.attrs.update(enable_int8=True, paddings=list(pads), fuse_act="relu", out_scale=0.05)
    graph.vars[conv.input("Input")].quant = QuantInfo.per_tensor(0.02)
    graph.vars[conv.input("Filter")].quant = QuantInfo.per_tensor(0.001)
    assert gemm_eligible(graph, conv)
    calls = []
    for name in ("conv", "gemm"):
        real = getattr(custom_ops, name)
        monkeypatch.setattr(custom_ops, name,
                            lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw))
    rng = np.random.default_rng(1)
    x, wt = _i8(rng, n, h, w, c), _i8(rng, kh, kw, c, oc)
    ctx = ExecutionContext(graph=graph, device=CPU)
    got = OPS.get("conv2d").impls["cuda"](ctx, conv, {"Input": [x], "Filter": [wt]})["Output"][0]
    assert calls == ["conv" if gathers else "gemm"]
    eff = eff_scale(ctx, conv, conv.input("Input"), conv.input("Filter"))
    want = km.int8_matmul_plain(im2col_nhwc(x, kh, kw, (sh, sw), pads), wt.reshape(-1, oc),
                                eff, act="relu", out_scale=0.05)
    assert torch.equal(got, want.reshape(g.n, g.oh, g.ow, oc))


def test_resnet_routes_16_convs_to_the_gather(monkeypatch):
    """ResNet-50 optimized and quantized on the CPU: a request calls the
    gathering conv 16 times (its 3x3 convs; the strided shortcuts carry a
    residual and keep the explicit rows), with the same output as the
    explicit rows (the plain version on the CPU either way)."""
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.core.executor import build_callable, stage_weights
    from paddle_lite_tpu_torch.tools.opt import optimize

    g = resnet.build(batch=1, image_size=32, seed=0)
    feed = {"image": np.random.default_rng(2).normal(size=(1, 32, 32, 3)).astype(np.float32)}
    optimize(g, quant=QuantConfig(), calib_batches=[feed], device=CPU)
    run = build_callable(g, device=CPU)
    weights = stage_weights(g, CPU)
    calls = []
    real = custom_ops.conv
    monkeypatch.setattr(custom_ops, "conv", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = run(weights, feed)[g.outputs[0]]
    assert len(calls) == 16
    monkeypatch.setattr(km, "gathers", lambda geom: False)
    assert torch.equal(got, run(weights, feed)[g.outputs[0]])
    assert len(calls) == 16


# ---- a gathering launch's plan ---------------------------------------------------

@pytest.mark.parametrize("c,width", [(2, 2), (6, 2), (4, 4), (12, 4), (8, 8), (24, 8),
                                     (16, 16), (96, 16), (1024, 16)])
def test_gather_plan_pieces_follow_c(monkeypatch, c, width):
    """A gathering plan's pieces are the widest of 16, 8, 4, 2 bytes that
    divides C, whatever K allows; it is the dense heuristic's at the rows'
    (M, K, N) otherwise, whatever plan is stored for the dense launch."""
    monkeypatch.setattr(tune_cache, "lookup_blocks", lambda *a: (8, 32, 1))
    m, k, n = 6272, 9 * c, 128
    for out in (km.OUT_I8, km.OUT_F32):
        p = km.default_plan(m, k, n, out, conv_c=c)
        dense = km.default_plan(m, k, n, out)
        assert p.conv and not dense.conv and p.width == width
        assert p._replace(width=dense.width, conv=False) == dense
        assert km.plan(m, k, n, out) == km.plan_of(m, k, n, out, 8, 32, 1)
    with pytest.raises(ValueError):
        km.plan_of(m, k, n, km.OUT_I32, 64, 64, 2, conv_c=c)
    with pytest.raises(ValueError):
        km.plan_of(m, k, n, km.OUT_I8, 64, 64, 2, residual=True, conv_c=c)


def test_custom_op_is_one_conv():
    """``plt::int8_conv`` on the CPU gives the plain version, its fake the
    NHWC output's shape and type."""
    case = EDGES["c24_3x3_s2_pads_1021"]
    g = _geom(case)
    rng = np.random.default_rng(4)
    x, w2 = _i8(rng, g.n, g.h, g.w, g.c), _i8(rng, g.k, case[-1])
    eff = torch.full((case[-1],), 1e-3)
    window = [g.kh, g.kw, g.sh, g.sw, g.pt, g.pb, g.pl, g.pr]
    for out_scale in (None, 0.5):
        got = torch.ops.plt.int8_conv(x, w2, eff, None, None, window, "relu", "", out_scale)
        want = km.int8_conv_plain(x, w2, eff, kh=g.kh, kw=g.kw, strides=(g.sh, g.sw),
                                  paddings=window[4:], act="relu", out_scale=out_scale)
        assert torch.equal(got, want)
        assert got.shape == (g.n, g.oh, g.ow, case[-1])
        with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
            fake = torch.ops.plt.int8_conv(mode.from_tensor(x), mode.from_tensor(w2),
                                           mode.from_tensor(eff), None, None, window,
                                           "relu", "", out_scale)
        assert fake.shape == got.shape and fake.dtype == got.dtype


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the GEMM kernel has no CPU mode); run this file on "
                    "the card with --noconftest, as its docstring says")
    return torch.device("cuda")


def _card_cases() -> dict:
    r50 = {k: v for k, v in _path_cases(32).items() if k.startswith("resnet")}
    assert len(r50) == 7  # ResNet-50's 16 gathering convs, 7 distinct
    return {**r50, **R50_STRIDED, **EDGES}


@pytest.mark.parametrize("out", ["int8", "fp32"])
@pytest.mark.parametrize("name", sorted(_card_cases()))
def test_gather_on_card_is_the_explicit_rows(cuda_device, name, out):
    """The gathering launch against the dense launch over
    ``im2col_nhwc``'s rows, bit for bit, and both against the plain
    version; one launch each, ``launches_conv`` counting the gathering one."""
    case = _card_cases()[name]
    g, oc = _geom(case), case[-1]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = _i8(rng, g.n, g.h, g.w, g.c).to(cuda_device)
    w2 = _i8(rng, g.k, oc).to(cuda_device)
    eff = torch.from_numpy(rng.uniform(1e-5, 2e-5, oc).astype(np.float32)).to(cuda_device)
    bias = torch.from_numpy(rng.normal(0, 0.5, oc).astype(np.float32)).to(cuda_device)
    window = dict(kh=g.kh, kw=g.kw, strides=(g.sh, g.sw), paddings=(g.pt, g.pb, g.pl, g.pr))
    kw = dict(act="relu")
    rows = im2col_nhwc(x, **window)
    if out == "int8":
        y = km.int8_matmul_plain(rows, w2, eff, bias, **kw)
        kw["out_scale"] = max(float(y.abs().max()), 1e-3) / 127 * 0.75
    before = (km.launches, km.launches_conv)
    got = km.int8_conv(x, w2, eff, bias, **window, **kw)
    assert (km.launches, km.launches_conv) == (before[0] + 1, before[1] + 1)
    explicit = km.int8_matmul(rows, w2, eff, bias, **kw)
    assert km.launches_conv == before[1] + 1
    assert torch.equal(got.reshape(g.m, oc), explicit), name
    assert torch.equal(explicit, km.int8_matmul_plain(rows, w2, eff, bias, **kw)), name


def test_resnet_call_on_card_is_the_explicit_rows(cuda_device, monkeypatch):
    """A whole ResNet-50 call (b4 at 224 px, eager) with its 16 gathering
    convs is bit-equal to the same call on the explicit rows."""
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.core.executor import build_callable, stage_weights
    from paddle_lite_tpu_torch.tools.opt import optimize

    g = resnet.build(batch=4, image_size=224, seed=0)
    rng = np.random.default_rng(5)
    feed = {"image": rng.normal(size=(4, 224, 224, 3)).astype(np.float32)}
    optimize(g, quant=QuantConfig(), calib_batches=[feed], device=cuda_device)
    run = build_callable(g, device=cuda_device)
    weights = stage_weights(g, cuda_device)
    before = km.launches_conv
    got = run(weights, feed)[g.outputs[0]]
    assert km.launches_conv == before + 16
    monkeypatch.setattr(km, "gathers", lambda geom: False)
    want = run(weights, feed)[g.outputs[0]]
    assert km.launches_conv == before + 16
    assert torch.equal(got, want)
