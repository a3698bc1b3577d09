"""Fused int8 depthwise (3x3, stride 1) + pointwise (1x1) block.

Port of ``paddle_lite_tpu/ops/kernels/dw_pw_fused.py`` (``fused_dw_pw_int8``
``:162``; Pallas kernel ``_kernel`` ``:41``).  On a CUDA tensor
:func:`fused_dw_pw_int8` launches the hand-written kernel
``csrc/dw_pw_fused.cu`` with the tiling :func:`plan` picks: persistent
blocks walk bands of output rows, copying the next band's halo while they
compute this one, run the stencil into an int8 sub-tile in shared memory
and the pointwise product through ``mma.sync``, and store the output in
whole rows (its header says what bounds it on an H100 and how the design
answers that).  The TPU kernel's grid over images, its row chunks and its
128-lane output blocks were VMEM and MXU choices and are not carried over.
On a CPU tensor it runs :func:`fused_dw_pw_int8_plain`, the same function
in plain PyTorch; there is no fallback from one to the other.

The arithmetic is that of :func:`.depthwise.dw_conv_int8` (with its int8
requant by ``fp32(1/dw_out_scale)``, ``dw_pw_fused.py:73`` there) followed by
:func:`.int8_matmul.int8_matmul`, so on identical inputs the fused kernel
equals the unfused pair of kernels bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..common import f32
from . import _build
from .depthwise import _cdiv, _splits, _up, dw_conv_int8_plain, vec_bytes
from .int8_matmul import act_args, int8_matmul_plain, inv_out_scale

# launches of the CUDA kernel, counted by the wrapper (CPU calls not counted)
launches = 0


def fused_dw_pw_int8_plain(x, dw_w, dw_eff, dw_bias, dw_out_scale, pw_w,
                           pw_eff, pw_bias, *, dw_act=None, dw_act_attrs=None,
                           pw_act=None, pw_act_attrs=None,
                           pw_out_scale=None) -> torch.Tensor:
    """Plain PyTorch version: the fp32 stencil and the shared epilogue to
    int8, then a float64 1x1 product and the epilogue."""
    n, h, w, c = x.shape
    d = dw_conv_int8_plain(x, dw_w, dw_eff, dw_bias, stride=1, act=dw_act,
                           act_attrs=dw_act_attrs, out_scale=dw_out_scale)
    pw2 = pw_w.reshape(c, -1)
    y = int8_matmul_plain(d.reshape(n * h * w, c), pw2, pw_eff, pw_bias,
                          act=pw_act, act_attrs=pw_act_attrs,
                          out_scale=pw_out_scale)
    return y.reshape(n, h, w, pw2.shape[1])


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"fused_dw_pw_int8: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


# ---- the kernel's tiling (csrc/dw_pw_fused.cu takes these numbers as given) ----

RUN = 7            # output columns of a stencil unit (P in dw_pw_fused.cu)
SUB_STEP = 224     # sub-tiles hold a multiple of lcm(RUN, 32) pixels
MAX_C = 128        # channels the kernel takes (the pass fuses C <= 128)
# The cost estimate's constants, in bytes moved: a sub-tile's fixed cost
# (two barriers, warps idle at the product's edge), and the cost of a pixel
# computed (stencil and product) per channel in and out.
SUBTILE_COST = 4096
PIXEL_COST = 0.25


class Layout(NamedTuple):
    """The kernel's thread layout and what the card holds of it, as the
    built library reports them (``plt_dw_pw_fused_layout``): threads a
    block, the most blocks an SM holds by registers and threads, the
    card's SMs, the shared bytes an SM has, the bytes the runtime keeps for
    each block, and the most one block may take."""
    threads: int
    blocks_per_sm: int
    sms: int
    smem_per_sm: int
    smem_reserved: int
    smem_per_block: int


def layout(device: Optional[int] = None) -> Layout:
    """:class:`Layout` of the kernel on CUDA device `device` (the current
    one by default)."""
    return _layout(torch.cuda.current_device() if device is None else device)


@functools.lru_cache(maxsize=None)
def _layout(device: int) -> Layout:
    import ctypes

    with torch.cuda.device(device):
        lib = _build.load("dw_pw_fused")
        vals = [ctypes.c_int() for _ in Layout._fields]
        _build.check(lib.plt_dw_pw_fused_layout(*[ctypes.byref(v) for v in vals]),
                     "dw_pw_fused layout")
    return Layout(*(v.value for v in vals))


class Plan(NamedTuple):
    """One launch's tiling.  A tile is one image's band of ``rows`` output
    rows × a strip of ``tw`` columns (``twp``: ``tw`` rounded up to runs of
    RUN); its halo, (rows+2) × (twp+2) pixels of C bytes, is copied in
    ``vec_bytes`` pieces.  A band's pixels go through the stencil and the
    pointwise product ``sub`` at a time, ``oc`` output channels a pass;
    outputs are stored in ``out_width``-byte pieces.  ``blocks`` persistent
    blocks (``blocks_per_sm`` an SM) of ``smem_bytes`` each walk the
    ``tiles`` tiles."""
    rows: int
    tw: int
    twp: int
    sub: int
    oc: int
    vec_bytes: int
    out_width: int
    blocks_per_sm: int
    smem_bytes: int
    tiles: int
    blocks: int


def smem_bytes(rows: int, twp: int, sub: int, oc: int, c: int, o: int,
               out_i8: bool) -> int:
    """Shared bytes of a block, as dw_pw_fused.cu lays them out: two halo
    buffers ((rows+2) rows of (twp+2)·C' bytes rounded up to 16, C' = C
    rounded up to 4), the int8 sub-tile and the pointwise weights (rows of
    C rounded up to 32, plus 16), the staged output sub-tile (rows of oc
    bytes + 16, or 4·oc + 32 for fp32), the scales and biases of every
    output-channel chunk, and the depthwise constants (5 rows of C' 4-byte
    words: each kernel row's weights packed, the scales, the biases)."""
    cs = _up(c, 4)
    rs = _up((twp + 2) * cs, 16)
    lda = _up(c, 32) + 16
    ldo = oc + 16 if out_i8 else 4 * oc + 32
    return (2 * (rows + 2) * rs + sub * lda + oc * lda + sub * ldo
            + 8 * _cdiv(o, oc) * oc + 20 * cs)


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, o: int, out_i8: bool, lay: Layout) -> Plan:
    """The tiling of one fused block, x (N, H, W, C) → (N, H, W, O), for the
    kernel's layout on a card (:func:`layout`): pure Python, so the CPU
    tests check it; the kernel checks what it is given and refuses a plan
    it cannot take.  Raises ValueError for a problem it cannot take (C past
    MAX_C, an empty shape, nothing that fits).

    A band spans the whole width where one fits (its output is then one
    contiguous run), else the widest even strip that fits.  Among even
    splits of the rows, sub-tiles of SUB_STEP pixels up to the band, output
    chunks (all of O where they fit, else 256 / 128 / 64 / 32) and 1 to
    ``lay.blocks_per_sm`` blocks an SM, the one that fits with the least
    estimated time: rounds of tiles over the resident blocks, a round as
    long as a tile's bytes (its halo rows included) and its sub-tiles'
    cost, times the blocks that share an SM."""
    if not (1 <= c <= MAX_C) or min(n, h, w, o) < 1:
        raise ValueError(f"dw_pw_fused: the kernel takes 1 <= C <= {MAX_C} and a "
                         f"non-empty shape, got N, H, W, C, O = {(n, h, w, c, o)}")
    es = 1 if out_i8 else 4
    vec = vec_bytes(c)
    ocs = [_up(o, 32)] + [v for v in (256, 128, 64, 32) if v < _up(o, 32)]
    best = None
    for tw in reversed(_splits(w)):  # the widest first
        twp = _up(tw, RUN)
        for bps in range(1, lay.blocks_per_sm + 1):
            budget = min(lay.smem_per_sm // bps - lay.smem_reserved, lay.smem_per_block)
            resident = lay.sms * bps
            for rows in _splits(h):
                tiles = n * _cdiv(h, rows) * _cdiv(w, tw)
                for oc in ocs:
                    ow = next(v for v in (16, 8, 4, 2, 1)
                              if (o * es) % v == 0 and (oc * es) % v == 0)
                    for sub in range(SUB_STEP, _up(rows * twp, SUB_STEP) + 1, SUB_STEP):
                        smem = smem_bytes(rows, twp, sub, oc, c, o, out_i8)
                        if smem > budget:
                            break
                        subs = _cdiv(rows * twp, sub) * _cdiv(o, oc)
                        per_tile = ((rows + 2) * (tw + 2) * c + rows * tw * o * es
                                    + subs * (SUBTILE_COST + sub * (c + o) * PIXEL_COST))
                        cost = _cdiv(tiles, resident) * per_tile * bps
                        key = (cost, -rows, -sub)
                        if best is None or key < best[0]:
                            best = (key, Plan(rows, tw, twp, sub, oc, vec, ow, bps, smem,
                                              tiles, min(tiles, resident)))
        if best is not None:
            break
    if best is None:
        raise ValueError(f"dw_pw_fused: no tiling of {(n, h, w, c, o)} fits "
                         f"{lay.smem_per_block} shared bytes")
    return best[1]


def fused_dw_pw_int8(
    x: torch.Tensor,       # (N, H, W, C) int8
    dw_w: torch.Tensor,    # (3, 3, 1, C) int8
    dw_eff,                # (C,) f32 = s_x * s_dw
    dw_bias: Optional[torch.Tensor],  # (C,) f32
    dw_out_scale: float,   # requant scale of the internal dw output
    pw_w: torch.Tensor,    # (1, 1, C, O) or (C, O) int8
    pw_eff,                # (O,) f32 = s_dwout * s_pw
    pw_bias: Optional[torch.Tensor],  # (O,) f32
    *,
    dw_act: Optional[str] = None,
    dw_act_attrs: Optional[dict] = None,
    pw_act: Optional[str] = None,
    pw_act_attrs: Optional[dict] = None,
    pw_out_scale: Optional[float] = None,
    pw_w_nk: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """dw 3x3/s1/SAME → dw epilogue → int8 → 1x1 → pw epilogue; fp32 out,
    or int8 when ``pw_out_scale`` is given.  ``pw_w_nk`` is the pointwise
    weight repacked to (O, C) once by a caller that runs it many times."""
    if x.device.type == "cpu":
        return fused_dw_pw_int8_plain(
            x, dw_w, dw_eff, dw_bias, dw_out_scale, pw_w, pw_eff, pw_bias,
            dw_act=dw_act, dw_act_attrs=dw_act_attrs, pw_act=pw_act,
            pw_act_attrs=pw_act_attrs, pw_out_scale=pw_out_scale)
    global launches
    dev = x.device
    _build.require_current_device(dev, "fused_dw_pw_int8")
    if x.ndim != 4:
        raise ValueError("fused_dw_pw_int8: x must be NHWC")
    n, h, w, c = x.shape
    o = pw_w.shape[-1]
    if pw_w.numel() != c * o:
        raise ValueError(f"fused_dw_pw_int8: pw_w {tuple(pw_w.shape)} is not "
                         f"(C, O) or (1, 1, C, O) with C = {c}")
    if pw_w_nk is None:
        _check(pw_w, "pw_w", torch.int8, pw_w.shape, dev)
        pw_w_nk = pw_w.reshape(c, o).t().contiguous()
    _check(x, "x", torch.int8, (n, h, w, c), dev)
    _check(dw_w, "dw_w", torch.int8, (3, 3, 1, c), dev)
    _check(pw_w_nk, "pw_w_nk", torch.int8, (o, c), dev)
    dw_scale = f32(dw_eff, dev).expand(c).contiguous()
    pw_scale = f32(pw_eff, dev).expand(o).contiguous()
    if dw_bias is not None:
        _check(dw_bias, "dw_bias", torch.float32, (c,), dev)
    if pw_bias is not None:
        _check(pw_bias, "pw_bias", torch.float32, (o,), dev)
    dw_a, pw_a = act_args(dw_act, dw_act_attrs), act_args(pw_act, pw_act_attrs)
    out_i8 = pw_out_scale is not None
    inv_dw = inv_out_scale(dw_out_scale)
    inv_pw = inv_out_scale(pw_out_scale) if out_i8 else 1.0
    if not (0 < inv_dw < float("inf") and 0 < inv_pw < float("inf")):
        raise ValueError(f"fused_dw_pw_int8: the requant scales must be positive and "
                         f"their inverses finite, got {dw_out_scale}, {pw_out_scale}")
    out = torch.empty((n, h, w, o), device=dev,
                      dtype=torch.int8 if out_i8 else torch.float32)
    p = plan(n, h, w, c, o, out_i8, layout(dev.index))
    for t, name in ((x, "x"), (pw_w_nk, "pw_w_nk")):
        if t.data_ptr() % p.vec_bytes:
            raise ValueError(f"fused_dw_pw_int8: {name}'s data is not {p.vec_bytes}-byte "
                             f"aligned, as the plan's copies need for C={c}")
    lib = _build.load("dw_pw_fused")
    rc = lib.plt_dw_pw_fused(
        x.data_ptr(), dw_w.data_ptr(), dw_scale.data_ptr(),
        None if dw_bias is None else dw_bias.data_ptr(), *dw_a,
        inv_dw, pw_w_nk.data_ptr(), pw_scale.data_ptr(),
        None if pw_bias is None else pw_bias.data_ptr(), *pw_a, int(out_i8), inv_pw,
        out.data_ptr(), n, h, w, c, o, p.rows, p.tw, p.twp, p.sub, p.oc,
        p.vec_bytes, p.out_width, p.smem_bytes, p.tiles, p.blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "dw_pw_fused")
    launches += 1
    return out
