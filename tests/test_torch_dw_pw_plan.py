"""The fused dw+pw kernel's plan (``ops/kernels/dw_pw_fused.plan``) and its
index math and arithmetic, on the CPU.

``csrc/dw_pw_fused.cu`` takes its tiling from ``plan`` and has no CPU mode,
so these tests hold the plan to what the kernel needs at MobileNetV1's two
fused shapes (read off the optimized b64/224 graph with ``fuse_dw_pw``) and
at edge shapes, and run a numpy emulation of the kernel (tiles decoded as
the kernel does, the halo copied into a zero-filled slab, sub-tiles of
units of 7 pixels x 4 channels, the product over whole sub-tiles with
whatever stale bytes the int8 tile holds, the store of the pixels in the
image) with its arithmetic: the stencil's byte transposes, windows and
``__dp4a`` sums on uint32 words, and the conversion-free float32 steps
(``small_int_to_float``, ``requant_lo``) against
``fused_dw_pw_int8_plain``, bit for bit.  The kernel itself is held to the plain version on the card by
``chip_smoke.py``.  One new shape (C = 40, odd O, hard_swish /
hard_sigmoid) holds the plain version to the Pallas kernel in interpret
mode, with ``tests/test_torch_dw_pw_fused.py``'s tie bound.
"""

import numpy as np
import pytest
import torch

from paddle_lite_tpu.ops.kernels.dw_pw_fused import fused_dw_pw_int8 as r_fused
from paddle_lite_tpu_torch.ops.common import apply_activation
from paddle_lite_tpu_torch.ops.kernels import _build
from paddle_lite_tpu_torch.ops.kernels.depthwise import dw_conv_int8_plain
from paddle_lite_tpu_torch.ops.kernels import dw_pw_fused as kf
from paddle_lite_tpu_torch.ops.kernels.int8_matmul import inv_out_scale

# what ``dw_pw_fused.layout`` (the library's ``plt_dw_pw_fused_layout``)
# reports on the H100; chip_smoke.py prints it in phase 1
H100 = kf.Layout(threads=512, blocks_per_sm=1, sms=132, smem_per_sm=233472,
                 smem_reserved=1024, smem_per_block=232448)
PATH = [(64, 112, 112, 32, 64), (64, 56, 56, 128, 128)]
# chip_smoke.py phase 5's ragged rows and the edge rows: C = 8, 24, 40, 72
# (8-byte copies), C % 4 != 0 (bytes), odd O, H off the band, W > 128
EDGE = [(4, 9, 150, 16, 32), (4, 7, 13, 30, 20), (2, 8, 8, 32, 160), (4, 14, 14, 64, 96),
        (2, 11, 11, 128, 128), (2, 13, 17, 8, 33), (2, 13, 17, 24, 31), (2, 13, 17, 40, 33),
        (2, 19, 130, 72, 24), (3, 30, 20, 128, 300)]


def _cdiv(a, b):
    return -(-a // b)


def _up(a, b):
    return _cdiv(a, b) * b


def halo_factor(h, w, rows, tw):
    """Input bytes the tiles read (halos inside the image) over the input's
    bytes: each band boundary re-reads two rows, each strip boundary two
    columns."""
    return ((h + 2 * (_cdiv(h, rows) - 1)) * (w + 2 * (_cdiv(w, tw) - 1))) / (h * w)


def test_path_shapes_are_the_optimized_graphs():
    from paddle_lite_tpu_torch import QuantConfig
    from paddle_lite_tpu_torch.models import mobilenet_v1
    from paddle_lite_tpu_torch.quant.calibrate import CalibrationResult
    from paddle_lite_tpu_torch.tools.opt import optimize

    g = mobilenet_v1.build(batch=64, image_size=224, seed=0)
    optimize(g, quant=QuantConfig(fuse_dw_pw=True), device="cpu",
             calib_result=CalibrationResult(scales={v: 0.05 for v in g.vars}))
    got = [tuple(g.vars[op.input("Input")].shape) + (g.vars[op.input("PwFilter")].shape[3],)
           for op in g.topological_order() if op.op_type == "fused_dw_pw"]
    assert got == PATH
    assert all(op.attrs["kernel"] == "cuda" and op.attrs.get("out_scale") is not None
               for op in g.ops if op.op_type == "fused_dw_pw")  # int8 out


def _check_plan(shape, out_i8, p, lay=H100):
    n, h, w, c, o = shape
    assert 1 <= p.blocks_per_sm <= lay.blocks_per_sm
    budget = min(lay.smem_per_sm // p.blocks_per_sm - lay.smem_reserved, lay.smem_per_block)
    assert p.smem_bytes == kf.smem_bytes(p.rows, p.twp, p.sub, p.oc, c, o, out_i8)
    assert p.smem_bytes <= budget
    assert p.twp == _up(p.tw, kf.RUN) and p.tw <= w and p.rows <= h
    assert p.sub % kf.SUB_STEP == 0 and kf.SUB_STEP <= p.sub <= _up(p.rows * p.twp, kf.SUB_STEP)
    assert p.oc % 32 == 0 and (p.oc >= o or p.oc in (32, 64, 128, 256))
    assert p.tiles == n * _cdiv(h, p.rows) * _cdiv(w, p.tw)
    assert p.blocks == min(p.tiles, lay.sms * p.blocks_per_sm)
    es = 1 if out_i8 else 4
    assert (o * es) % p.out_width == 0 and (p.oc * es) % p.out_width == 0
    assert p.out_width == max(v for v in (16, 8, 4, 2, 1)
                              if (o * es) % v == 0 and (p.oc * es) % v == 0)
    assert c % p.vec_bytes == 0 and p.vec_bytes == kf.vec_bytes(c)


@pytest.mark.parametrize("shape", PATH)
@pytest.mark.parametrize("out_i8", [True, False])
def test_plan_at_the_path_shapes(shape, out_i8):
    n, h, w, c, o = shape
    p = kf.plan(*shape, out_i8, H100)
    _check_plan(shape, out_i8, p)
    assert p.tw == w  # a band's output is one contiguous run
    assert p.blocks == H100.sms  # every SM has tiles
    assert p.vec_bytes == 16 and p.out_width == 16
    if out_i8:  # the path's blocks: the halo read at most 1.25x the input
        assert halo_factor(h, w, p.rows, p.tw) <= 1.25


@pytest.mark.parametrize("shape", EDGE)
@pytest.mark.parametrize("out_i8", [True, False])
def test_plan_at_the_edge_shapes(shape, out_i8):
    _check_plan(shape, out_i8, kf.plan(*shape, out_i8, H100))


@pytest.mark.parametrize("c,vec", [(8, 8), (24, 8), (40, 8), (72, 8), (16, 16), (32, 16),
                                   (128, 16), (12, 4), (20, 4), (30, 1), (7, 1), (1, 1)])
def test_plan_copy_width(c, vec):
    assert kf.plan(2, 9, 10, c, 32, True, H100).vec_bytes == vec


@pytest.mark.parametrize("o,out_i8,width", [(64, True, 16), (33, True, 1), (31, False, 4),
                                            (20, True, 4), (30, True, 2), (24, False, 16),
                                            (72, True, 8)])
def test_plan_store_width(o, out_i8, width):
    assert kf.plan(2, 9, 10, 16, o, out_i8, H100).out_width == width


def test_plan_chunks_o_only_where_it_does_not_fit():
    assert kf.plan(2, 9, 10, 32, 300, True, H100).oc == 320  # all of O fits
    small = H100._replace(smem_per_block=40000, smem_per_sm=41024)
    p = kf.plan(2, 9, 10, 32, 300, True, small)
    assert p.oc < 300 and p.smem_bytes <= 40000
    _check_plan((2, 9, 10, 32, 300), True, p, small)


def test_plan_strips_where_the_width_does_not_fit():
    small = H100._replace(smem_per_block=60000, smem_per_sm=61024)
    p = kf.plan(1, 8, 1000, 32, 32, True, small)
    assert p.tw < 1000
    _check_plan((1, 8, 1000, 32, 32), True, p, small)


@pytest.mark.parametrize("shape,lay", [
    ((2, 8, 8, 129, 32), H100),      # past C = 128
    ((2, 8, 8, 0, 32), H100),
    ((0, 8, 8, 32, 32), H100),
    ((2, 8, 8, 32, 0), H100),
    ((2, 8, 8, 32, 32), H100._replace(smem_per_block=8192, smem_per_sm=9216)),  # nothing fits
])
def test_plan_refuses_what_the_kernel_cannot_take(shape, lay):
    with pytest.raises(ValueError):
        kf.plan(*shape, True, lay)


# ---- a numpy emulation of the kernel ------------------------------------------

_OFFSET = 256 * 128 * 127  # epilogue.cuh's SMALL_OFFSET


def _small_int_to_float(a):
    assert np.abs(a).max(initial=0) < (1 << 23) - _OFFSET  # inside the window
    bits = np.int32(0x4B000000 + _OFFSET) + a.astype(np.int32)
    return bits.view(np.float32) - np.float32(8388608.0 + _OFFSET)


def _requant_lo(y, inv):
    t = np.fmin(np.fmax(y * inv, np.float32(-127)), np.float32(127))
    return (t + np.float32(12582912.0)).view(np.uint32).astype(np.uint8).view(np.int8)


def _byte_perm(x, y, sel):
    """__byte_perm: result byte k is byte nibble k of sel of the 8 bytes of
    (y:x), x's bytes 0-3 and y's 4-7."""
    src = [(x >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
    src += [(y >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
    return sum(src[(sel >> 4 * k) & 7] << np.uint32(8 * k) for k in range(4)).astype(np.uint32)


def _dp4a(a, b):
    """__dp4a's sum of the four signed byte products."""
    sa = a[..., None].view(np.int8).astype(np.int32)
    sb = b[..., None].view(np.int8).astype(np.int32)
    return (sa * sb).sum(-1)


def _stencil_row(xw, wrow):
    """One kernel row of the kernel's stencil units: xw (units, 9 pixels,
    channel groups) words of 4 channels, wrow (channels,) weight words.
    Each channel's pixels 0-3 and 4-7 as words by two 4 x 4 byte
    transposes, then each output's window of 3 pixels (and a fourth byte,
    times 0) by a byte permute, against the row's weights by __dp4a;
    returns (units, 7, channels) int32 sums."""
    units, _, groups = xw.shape
    t = []
    for b in range(2):
        x0, x1, x2, x3 = (xw[:, 4 * b + k] for k in range(4))
        e0, e1 = _byte_perm(x0, x1, 0x5140), _byte_perm(x0, x1, 0x7362)
        e2, e3 = _byte_perm(x2, x3, 0x5140), _byte_perm(x2, x3, 0x7362)
        t.append([_byte_perm(e0, e2, 0x5410), _byte_perm(e0, e2, 0x7632),
                  _byte_perm(e1, e3, 0x5410), _byte_perm(e1, e3, 0x7632)])
    out = np.zeros((units, kf.RUN, groups, 4), np.int32)
    x8 = xw[:, 8]
    for j in range(4):
        t0, t1 = t[0][j], t[1][j]
        win = [t0, _byte_perm(t0, t1, 0x4321), _byte_perm(t0, t1, 0x5432),
               _byte_perm(t0, t1, 0x6543), t1, _byte_perm(t1, x8, 0x0321 | (4 + j) << 12),
               _byte_perm(t1, x8, 0x0032 | (4 + j) << 8)]
        for p, wv in enumerate(win):
            out[:, p, :, j] = _dp4a(wv, wrow[j::4])
    return out.reshape(units, kf.RUN, groups * 4)


def _act(y, act, attrs):
    return apply_activation(torch.from_numpy(y), act, attrs).numpy()


def _emulate(x, dw, dw_eff, dw_bias, dw_out_scale, pw, pw_eff, pw_bias, p, *, dw_act,
             pw_act, pw_out_scale, dw_attrs=None, pw_attrs=None, seed=0):
    """The kernel's loops: tiles (strips fastest, then bands, then images),
    the halo slab, sub-tiles of units, the product over the whole sub-tile
    and its epilogue, the store of the pixels in the image; every output
    written exactly once."""
    rng = np.random.default_rng(seed)
    n, h, w, c = x.shape
    o = pw.shape[1]
    cs, kp = _up(c, 4), _up(c, 32)
    chunks = _cdiv(o, p.oc)
    f32 = np.float32
    # the depthwise constants (zeros past C; -0 biases without a bias)
    wq = np.zeros((3, cs), np.uint32)  # a kernel row's 3 weights of a channel, bytes 0-2
    for i in range(3):
        for kj in range(3):
            wq[i, :c] |= dw[i, kj, 0].view(np.uint8).astype(np.uint32) << np.uint32(8 * kj)
    sc = np.zeros(cs, f32)
    sc[:c] = dw_eff
    bi = np.full(cs, -0.0, f32)
    if dw_bias is not None:
        bi[:c] = dw_bias
    # the pointwise weights (O, C) and every chunk's scales and biases
    w_nk = np.zeros((chunks * p.oc, kp), np.int8)
    w_nk[:o, :c] = pw.T
    psc = np.zeros(chunks * p.oc, f32)
    psc[:o] = pw_eff
    pbi = np.zeros(chunks * p.oc, f32)
    pbi[:o] = pw_bias if pw_bias is not None else -0.0
    inv_dw = f32(inv_out_scale(dw_out_scale))
    out_i8 = pw_out_scale is not None
    inv = f32(inv_out_scale(pw_out_scale)) if out_i8 else None
    out = np.zeros((n, h, w, o), np.int8 if out_i8 else f32)
    written = np.zeros((n, h, w, o), np.int32)
    strips, bands = _cdiv(w, p.tw), _cdiv(h, p.rows)
    for t in range(p.tiles):
        q, s = divmod(t, strips)
        img, b = divmod(q, bands)
        h0, w0 = b * p.rows, s * p.tw
        rv, wv = min(p.rows, h - h0), min(p.tw, w - w0)
        slab = np.zeros((p.rows + 2, p.twp + 2, cs), np.int8)  # zero fill outside the image
        for r in range(p.rows + 2):
            ih = h0 - 1 + r
            if 0 <= ih < h:
                lo, hi = max(w0 - 1, 0), min(w0 + p.twp + 1, w)
                slab[r, lo - (w0 - 1):hi - (w0 - 1), :c] = x[img, ih, lo:hi]
        words = np.ascontiguousarray(slab).view(np.uint32)  # (rows + 2, twp + 2, cs / 4)
        for q0 in range(0, rv * p.twp, p.sub):
            dtile = rng.integers(-128, 128, (p.sub, kp), dtype=np.int8)  # stale bytes
            pix = q0 + np.arange(p.sub)
            r, wl = pix // p.twp, pix % p.twp
            unit_r = (q0 + (np.arange(p.sub) // kf.RUN) * kf.RUN) // p.twp
            assert (unit_r == r).all()  # a unit's 7 pixels lie in one row
            live = r < rv  # units past the band or the image are skipped
            first = np.arange(0, p.sub, kf.RUN)
            ur, uw = r[first][live[first]], wl[first][live[first]]
            acc = np.zeros((len(ur), kf.RUN, cs), np.int32)
            for i in range(3):  # the unit's 9 words of each channel group, its windows
                xw = words[ur[:, None] + i, uw[:, None] + np.arange(kf.RUN + 2)]
                acc += _stencil_row(xw, wq[i])
            y = _act(_small_int_to_float(acc.reshape(-1, cs)) * sc + bi, dw_act, dw_attrs)
            dtile[live, :cs] = _requant_lo(y, inv_dw)
            for o0 in range(0, o, p.oc):
                a = dtile.astype(np.int64) @ w_nk[o0:o0 + p.oc].astype(np.int64).T
                z = _small_int_to_float(a) * psc[o0:o0 + p.oc] + pbi[o0:o0 + p.oc]
                z = _act(z, pw_act, pw_attrs)
                stage = _requant_lo(z, inv) if out_i8 else z
                valid = min(p.oc, o - o0)
                for row in np.nonzero((r < rv) & (wl < wv))[0]:
                    at = (img, h0 + r[row], w0 + wl[row], slice(o0, o0 + valid))
                    out[at] = stage[row, :valid]
                    written[at] += 1
    assert (written == 1).all()
    return out


def _problem(rng, n, h, w, c, o, bias=True):
    x = rng.integers(-127, 128, size=(n, h, w, c), dtype=np.int8)
    dw = rng.integers(-127, 128, size=(3, 3, 1, c), dtype=np.int8)
    pw = rng.integers(-127, 128, size=(c, o), dtype=np.int8)
    dw_eff = rng.uniform(1e-3, 2e-3, c).astype(np.float32)
    dw_b = rng.normal(0, 0.5, c).astype(np.float32) if bias else None
    pw_eff = rng.uniform(1e-3, 2e-3, o).astype(np.float32)
    pw_b = rng.normal(0, 0.5, o).astype(np.float32) if bias else None
    return x, dw, dw_eff, dw_b, pw, pw_eff, pw_b


def _hand_plan(shape, out_i8, **kw):
    """A plan with other tiles than ``plan`` picks, by its rules, so the
    emulation also walks bands off H, strips, several sub-tiles a band and
    output chunks."""
    n, h, w, c, o = shape
    p = kf.plan(*shape, out_i8, H100)._replace(**kw)
    p = p._replace(twp=_up(p.tw, kf.RUN))
    tiles = n * _cdiv(h, p.rows) * _cdiv(w, p.tw)
    p = p._replace(smem_bytes=kf.smem_bytes(p.rows, p.twp, p.sub, p.oc, c, o, out_i8),
                   tiles=tiles, blocks=min(tiles, H100.sms))
    _check_plan(shape, out_i8, p)
    return p


EMULATED = [
    # shape, int8 out, dw act, pw act, plan overrides, bias
    ((2, 9, 14, 16, 32), True, "relu", "relu", {}, True),
    ((2, 7, 13, 30, 20), False, "relu", "relu6", {}, True),           # bytes, C % 4 != 0
    ((1, 10, 9, 40, 33), True, "hard_swish", "hard_sigmoid", {}, True),  # 8-byte copies, odd O
    ((2, 6, 8, 24, 31), False, "leaky_relu", None, {}, False),        # odd O, no bias
    ((2, 10, 90, 8, 70), True, "relu", "hard_swish", dict(rows=3, sub=224, oc=32), True),
    ((1, 11, 40, 72, 24), True, "relu6", "relu", dict(rows=4, tw=17), True),  # strips, bands off H
    ((1, 5, 130, 16, 40), False, "relu", "relu", dict(rows=2, sub=224, oc=32), True),  # W > 128
]


@pytest.mark.parametrize("shape,out_i8,dw_act,pw_act,hand,bias", EMULATED)
def test_emulated_kernel_equals_plain(shape, out_i8, dw_act, pw_act, hand, bias):
    rng = np.random.default_rng(sum(shape))
    x, dw, de, db, pw, pe, pb = _problem(rng, *shape, bias=bias)
    p = _hand_plan(shape, out_i8, **hand) if hand else kf.plan(*shape, out_i8, H100)
    _check_plan(shape, out_i8, p)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    d = dw_conv_int8_plain(t(x), t(dw), t(de), t(db), act=dw_act)
    dw_s = float(d.abs().max()) / 127 * 0.75
    y = kf.fused_dw_pw_int8_plain(t(x), t(dw), t(de), t(db), dw_s, t(pw), t(pe), t(pb),
                                  dw_act=dw_act, pw_act=pw_act)
    kw = dict(dw_act=dw_act, pw_act=pw_act,
              pw_out_scale=float(y.abs().max()) / 127 * 0.75 if out_i8 else None)
    want = kf.fused_dw_pw_int8_plain(t(x), t(dw), t(de), t(db), dw_s, t(pw), t(pe), t(pb),
                                     **kw).numpy()
    got = _emulate(x, dw, de, db, dw_s, pw, pe, pb, p, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32) if not out_i8 else got,
                                  want.view(np.int32) if not out_i8 else want)


# ---- the plain version against the Pallas kernel at a new shape -----------

@pytest.mark.parametrize("out_i8", [True, False])
def test_plain_vs_pallas_c40_odd_o(out_i8):
    """C = 40 (8-byte copies), O = 33, hard_swish / hard_sigmoid, against the
    JAX kernel in interpret mode: int8 outputs may differ at requant ties
    only (at most 2, by 1 LSB: the reference's XLA may round hard_swish's
    division otherwise), fp32 rtol 1e-6 (one ulp)."""
    rng = np.random.default_rng(40)
    x, dw, de, db, pw, pe, pb = _problem(rng, 2, 7, 9, 40, 33)
    kw = dict(dw_act="hard_swish", pw_act="hard_sigmoid",
              pw_act_attrs={"slope": 0.2, "offset": 0.5},
              pw_out_scale=0.01 if out_i8 else None)
    ref = np.asarray(r_fused(x, dw, de, db, 0.05, pw, pe, pb, interpret=True, **kw))
    t = torch.from_numpy
    got = kf.fused_dw_pw_int8(t(x), t(dw), t(de), t(db), 0.05, t(pw), t(pe), t(pb),
                              **kw).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if out_i8:
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert d.max() <= 1 and (d > 0).sum() <= 2
        assert np.unique(got).size > 3  # the scale leaves a spread of values
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# ---- the per-device set-up -----------------------------------------------------

class _FakeLib:
    """Stands in for the built library: counts its per-device set-up and
    reports a layout that names the device it was asked on."""

    def __init__(self):
        self.prepared = []
        self.device = 0

    def plt_dw_pw_fused_prepare(self):
        self.prepared.append(self.device)
        return 0

    def plt_dw_pw_fused_layout(self, *outs):
        for i, v in enumerate(outs):
            v._obj.value = 100 * self.device + i + 1
        return 0


def test_prepare_runs_once_per_device(monkeypatch):
    assert _build.PREPARE["dw_pw_fused"] == "plt_dw_pw_fused_prepare"
    lib = _FakeLib()
    monkeypatch.setattr(_build, "_LIBS", {"dw_pw_fused": lib})
    monkeypatch.setattr(_build, "_PREPARED", set())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: lib.device)
    for dev in (0, 0, 1, 1, 0):
        lib.device = dev
        assert _build.load("dw_pw_fused") is lib
    assert lib.prepared == [0, 1]


def test_layout_is_per_device(monkeypatch):
    import contextlib

    lib = _FakeLib()
    monkeypatch.setattr(_build, "_LIBS", {"dw_pw_fused": lib})
    monkeypatch.setattr(_build, "_PREPARED", set())

    @contextlib.contextmanager
    def on(device):
        prev, lib.device = lib.device, device
        yield
        lib.device = prev

    monkeypatch.setattr(torch.cuda, "device", on)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: lib.device)
    kf._layout.cache_clear()
    try:
        a, b = kf.layout(device=0), kf.layout(device=1)
        assert a.threads == 1 and b.threads == 101  # asked on its own device
        assert kf.layout(device=1) is b             # and kept per device
        assert lib.prepared == [0, 1]
    finally:
        kf._layout.cache_clear()


def test_the_source_has_no_function_local_static():
    src = (_build.CSRC / "dw_pw_fused.cu").read_text()
    assert "static const" not in src and "static cudaError_t" not in src


@pytest.mark.parametrize("act", ["relu", "relu6", "hard_sigmoid"])
@pytest.mark.parametrize("inv", [1e-45, 1e-30, 0.37, 1.0, 3e10, 3.4e38])
def test_requant_without_the_lower_clip_after_a_nonnegative_activation(act, inv):
    """The kernel's requant_byte<true>: after relu, relu6 or hard_sigmoid
    (outputs >= 0, or -0) and with a finite inverse scale > 0 (the launch
    refuses any other), leaving out requant_lo's lower clip changes no
    byte."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32)
    y = np.concatenate([bits.view(np.float32), np.arange(-300, 300, 0.25, dtype=np.float32),
                        np.array([np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32)])
    zero, one, six = np.float32(0), np.float32(1), np.float32(6)
    with np.errstate(all="ignore"):  # the kernel's fmaxf / fminf: a NaN input gives 0
        y = {"relu": lambda v: np.fmax(v, zero),
             "relu6": lambda v: np.fmin(np.fmax(v, zero), six),
             "hard_sigmoid": lambda v: np.fmin(np.fmax(np.float32(0.2) * v + np.float32(0.5),
                                                       zero), one)}[act](y)
        inv = np.float32(inv)
        t = np.fmin(y * inv, np.float32(127))
        short = (t + np.float32(12582912.0)).view(np.uint32).astype(np.uint8).view(np.int8)
        np.testing.assert_array_equal(short, _requant_lo(y, inv))
