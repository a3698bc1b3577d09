"""The depthwise kernel's tiling plan (``ops/kernels/depthwise.plan``) and
its index math, on the CPU.

``csrc/dw_conv.cu`` takes its tiles from ``plan`` and has no CPU mode, so
these tests hold the plan to what the kernel needs at every depthwise shape
of the four paths that ``chip_smoke.py`` drives (MobileNetV1 b64/224, SSD
b32/300, MobileNetV1 with ``fuse_dw_pw`` — a subset of the first — and
MobileNetV3-Large b64/224) and at ragged ones, and run a numpy emulation of
the kernel's block loop (halo copy into a zero-filled slab with the plan's
row stride, units of (image, row, run of columns), the store of the
tile) against ``dw_conv_int8_plain``, bit for bit.  The kernel itself is
held to the plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from paddle_lite_tpu.ops.kernels import depthwise as r_dw
from paddle_lite_tpu_torch.ops.kernels import depthwise as p_dw

MNV1 = [(64, 112, 112, 32, 3, 1), (64, 112, 112, 64, 3, 2), (64, 56, 56, 128, 3, 1),
        (64, 56, 56, 128, 3, 2), (64, 28, 28, 256, 3, 1), (64, 28, 28, 256, 3, 2),
        (64, 14, 14, 512, 3, 1), (64, 14, 14, 512, 3, 2), (64, 7, 7, 1024, 3, 1)]
SSD = [(32, 150, 150, 32, 3, 1), (32, 150, 150, 64, 3, 2), (32, 75, 75, 128, 3, 1),
       (32, 75, 75, 128, 3, 2), (32, 38, 38, 256, 3, 1), (32, 38, 38, 256, 3, 2),
       (32, 19, 19, 512, 3, 1), (32, 19, 19, 512, 3, 2), (32, 10, 10, 1024, 3, 1)]
MNV3 = [(64, 112, 112, 16, 3, 1), (64, 112, 112, 64, 3, 2), (64, 56, 56, 72, 3, 1),
        (64, 56, 56, 72, 5, 2), (64, 28, 28, 120, 5, 1), (64, 28, 28, 240, 3, 2),
        (64, 14, 14, 200, 3, 1), (64, 14, 14, 184, 3, 1), (64, 14, 14, 480, 3, 1),
        (64, 14, 14, 672, 3, 1), (64, 14, 14, 672, 5, 2), (64, 7, 7, 960, 5, 1)]
# chip_smoke.py phase 2's extra and ragged cases
RAGGED = [(64, 56, 56, 128, 3, 1), (8, 28, 28, 96, 5, 1), (8, 27, 27, 96, 5, 2),
          (4, 19, 23, 30, 3, 2), (4, 17, 13, 37, 3, 1), (4, 29, 31, 72, 3, 2),
          (2, 15, 9, 24, 5, 1), (1, 9, 9, 8, 3, 1), (1, 33, 40, 48, 5, 2)]
PATHS = MNV1 + SSD + MNV3
# what ``depthwise.layout`` (the library's ``plt_dw_conv_layout``) reports
# on the H100, by kernel size; chip_smoke.py prints it in phase 1
H100 = {3: p_dw.Layout(threads=256, channels=4, blocks_per_sm=2, sms=132, smem_per_block=115712),
        5: p_dw.Layout(threads=256, channels=4, blocks_per_sm=1, sms=132, smem_per_block=232448)}


def _plan(shape):
    return p_dw.plan(*shape, H100[shape[4]])


def test_path_shapes_are_the_graphs():
    """The lists above are what the models' graphs hold."""
    from paddle_lite_tpu_torch.models import mobilenet_v1, mobilenet_v3, ssd

    def dws(g):
        out = []
        for op in g.topological_order():
            if op.op_type == "depthwise_conv2d":
                n, h, w, c = g.vars[op.input("Input")].shape
                k = g.vars[op.input("Filter")].shape[0]
                out.append((n, h, w, c, k, int(op.attrs["strides"][0])))
        return sorted(set(out))

    assert dws(mobilenet_v1.build(batch=64, image_size=224, seed=0)) == sorted(MNV1)
    assert dws(ssd.build(batch=32, image_size=300, num_classes=21, seed=0)) == sorted(SSD)
    assert dws(mobilenet_v3.build(batch=64, image_size=224, seed=0,
                                  with_softmax=False)) == sorted(MNV3)


def _blocks(pl, n, oh, ow, c):
    """(n0, oh0, ow0, c0) of every block, decoded from the grid as the
    kernel does: channel chunk fastest, then column tile, then row tile."""
    chunks, tiles_w = -(-c // pl.cv), -(-ow // pl.tw)
    for by in range(pl.grid[1]):
        for bx in range(pl.grid[0]):
            rest, chunk = divmod(bx, chunks)
            ty, tx = divmod(rest, tiles_w)
            yield by * pl.images_per_block, ty * pl.th, tx * pl.tw, chunk * pl.cv


@pytest.mark.parametrize("shape", sorted(set(PATHS + RAGGED)))
def test_plan_covers_fits_and_fills(shape):
    n, h, w, c, k, s = shape
    pl = _plan(shape)
    oh, ow = p_dw.out_size(h, k, s), p_dw.out_size(w, k, s)
    # every output exactly once: rows × columns × channels over one image
    # group, and the image groups over N (the tiling is their product)
    cover = np.zeros((oh, ow, c), np.int32)
    groups = set()
    for n0, oh0, ow0, c0 in _blocks(pl, n, oh, ow, c):
        groups.add(n0)
        if n0 == 0:
            cover[oh0:oh0 + pl.th, ow0:ow0 + pl.tw, c0:c0 + pl.cv] += 1
    assert (cover == 1).all()
    covered_n = sorted(i for n0 in groups for i in range(n0, min(n0 + pl.images_per_block, n)))
    assert covered_n == list(range(n))
    # shared memory: the halo slab (rows of row_stride bytes) and the
    # staged int8 tile, within what one block may take
    sh, sw = (pl.th - 1) * s + k, (pl.tw - 1) * s + k
    rs = p_dw.row_stride(pl.tw, pl.cv, pl.vec_bytes, k, s)
    assert sw * pl.cv <= rs < sw * pl.cv + max(pl.vec_bytes, 4) and rs % 4 == 0
    halo = -(-pl.images_per_block * sh * rs // 16) * 16
    consts = -(-k * k * pl.cv // 16) * 16 + 8 * pl.cv
    assert pl.smem_bytes == 2 * (halo + consts) + pl.images_per_block * pl.th * pl.tw * pl.cv
    assert pl.smem_bytes <= min(227 * 1024, H100[k].smem_per_block)
    # vectors: as wide as C allows, and the channel chunk made of them
    assert c % pl.vec_bytes == 0 and pl.cv % pl.vec_bytes == 0 and pl.cv % 4 == 0
    if c % 16 == 0:
        assert pl.vec_bytes == 16
    assert pl.vec_bytes == max(v for v in (16, 8, 4, 1) if c % v == 0)
    # runs of 7 columns; no idle column at MobileNet's widths (multiples of 7)
    assert pl.tw % p_dw.RUN == 0
    if ow % p_dw.RUN == 0:
        assert ow % pl.tw == 0
    assert pl.images_per_block == 1 or pl.th == oh
    if shape in PATHS:  # the paths' shapes fill the H100's 132 SMs
        assert pl.grid[0] * pl.grid[1] >= H100[k].sms == 132


def _emulate(x, wt, pl, s):
    """The kernel's block loop in numpy: the integer accumulators, each
    output written by the block and unit that own it."""
    n, h, w, c = x.shape
    k = wt.shape[0]
    pad = (k - 1) // 2
    oh, ow = p_dw.out_size(h, k, s), p_dw.out_size(w, k, s)
    ipb, th, tw, cv = pl.images_per_block, pl.th, pl.tw, pl.cv
    rs = p_dw.row_stride(tw, cv, pl.vec_bytes, k, s)
    sh, sw = (th - 1) * s + k, (tw - 1) * s + k
    P = p_dw.RUN
    lay = H100[k]
    runs, g = tw // P, cv // lay.channels
    ustep = lay.threads // g
    acc = np.full((n, oh, ow, c), np.nan, np.float32)
    wf = wt[:, :, 0, :].astype(np.float32)
    for n0, oh0, ow0, c0 in _blocks(pl, n, oh, ow, c):
        # the halo: zeros outside the image, past C and past N
        slab = np.zeros(ipb * sh * rs, np.int8)
        for img in range(ipb):
            for hr in range(sh):
                ih = oh0 * s - pad + hr
                if n0 + img >= n or not 0 <= ih < h:
                    continue
                for col in range(sw):
                    iw = ow0 * s - pad + col
                    if 0 <= iw < w:
                        at = (img * sh + hr) * rs + col * cv
                        piece = x[n0 + img, ih, iw, c0:c0 + cv]
                        slab[at:at + len(piece)] = piece
        # the threads' units: channel group t % g, unit t // g, then + ustep
        for u in range(ipb * th * runs):
            q, r = divmod(u, th)
            img, run = divmod(q, runs)
            if n0 + img >= n or oh0 + r >= oh:
                continue
            assert u % ustep < ustep  # some thread of the block owns it
            base = (img * sh + r * s) * rs + run * P * s * cv
            a = np.zeros((P, cv), np.float32)
            wpad = np.zeros((k, k, cv), np.float32)
            nc = min(cv, c - c0)
            wpad[:, :, :nc] = wf[:, :, c0:c0 + nc]
            for i in range(k):
                for col in range((P - 1) * s + k):
                    at = base + i * rs + col * cv
                    xv = slab[at:at + cv].astype(np.float32)
                    for p in range(P):
                        kj = col - p * s
                        if 0 <= kj < k:
                            a[p] += xv * wpad[i, kj]
            for p in range(P):
                o = ow0 + run * P + p
                if o < ow:
                    assert np.isnan(acc[n0 + img, oh0 + r, o, c0:c0 + nc]).all()
                    acc[n0 + img, oh0 + r, o, c0:c0 + nc] = a[p, :nc]
    return acc


def _hand_plan(shape, th, ipb):
    """A plan with other tiles than ``plan`` picks, built by its rules, so
    the emulation also walks several images a block and ragged row tiles."""
    n, h, w, c, k, s = shape
    base = _plan(shape)
    oh, ow = p_dw.out_size(h, k, s), p_dw.out_size(w, k, s)
    smem = p_dw.smem_bytes(th, base.tw, base.cv, base.vec_bytes, ipb, k, s)
    grid = (-(-oh // th) * -(-ow // base.tw) * -(-c // base.cv), -(-n // ipb))
    return base._replace(th=th, images_per_block=ipb, smem_bytes=smem, grid=grid)


EMULATED = [
    ((2, 12, 12, 16, 3, 1), None),
    ((2, 13, 11, 24, 3, 2), None),       # H, W off the tile
    ((1, 12, 15, 40, 5, 1), None),       # N = 1, k = 5
    ((2, 17, 19, 72, 5, 2), None),       # C = 72 (8-byte vectors), k = 5, s = 2
    ((2, 9, 10, 30, 3, 2), None),        # C % 4 != 0 (byte copies)
    ((3, 7, 7, 64, 3, 1), (7, 2)),       # two images a block, a group past N
    ((2, 11, 16, 32, 3, 1), (4, 1)),     # row tiles past OH
    ((2, 13, 9, 8, 5, 2), (3, 1)),
]


@pytest.mark.parametrize("shape,hand", EMULATED)
def test_emulated_tiles_equal_plain(shape, hand):
    n, h, w, c, k, s = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-127, 128, size=(n, h, w, c), dtype=np.int8)
    wt = rng.integers(-127, 128, size=(k, k, 1, c), dtype=np.int8)
    pl = _plan(shape) if hand is None else _hand_plan(shape, *hand)
    acc = _emulate(x, wt, pl, s)
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    ref = p_dw.dw_conv_int8_plain(xt, wtt, torch.ones(c), stride=s).numpy()
    np.testing.assert_array_equal(acc, ref)
    # and the epilogue on the emulated accumulators: the plain output
    eff = torch.from_numpy(rng.uniform(1e-3, 2e-3, c).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32))
    for act, out_scale in (("hard_swish", 0.05), ("relu", None), (None, 0.08)):
        got = p_dw.epilogue(torch.from_numpy(acc), eff, bias, act, None, out_scale)
        want = p_dw.dw_conv_int8_plain(xt, wtt, eff, bias, stride=s, act=act,
                                       out_scale=out_scale)
        assert torch.equal(got, want)


def test_plain_vs_pallas_c72_k5_s2():
    """The new ragged shape against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(72)
    n, h, w, c, k, s = 2, 15, 13, 72, 5, 2
    x = rng.integers(-127, 128, size=(n, h, w, c), dtype=np.int8)
    wt = rng.integers(-127, 128, size=(k, k, 1, c), dtype=np.int8)
    eff = rng.uniform(1e-3, 2e-3, size=(c,)).astype(np.float32)
    bias = rng.normal(0, 0.5, size=(c,)).astype(np.float32)
    y = r_dw.dw_conv_int8(x, wt, eff, bias, stride=s, act="relu", interpret=True)
    out_scale = float(np.abs(np.asarray(y)).max()) / 127 * 0.75
    ref = r_dw.dw_conv_int8(x, wt, eff, bias, stride=s, act="relu",
                            out_scale=out_scale, interpret=True)
    got = p_dw.dw_conv_int8(torch.from_numpy(x), torch.from_numpy(wt),
                            torch.from_numpy(eff), torch.from_numpy(bias),
                            stride=s, act="relu", out_scale=out_scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

