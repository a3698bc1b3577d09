"""int8 NHWC depthwise convolution with the fused int8 epilogue.

Port of ``paddle_lite_tpu/ops/kernels/depthwise.py``: ``dw_conv_int8``
(``:365``; Pallas kernels ``_dw_kernel_s1`` ``:243`` and ``_dw_kernel_s2``
``:210``) and ``dw_conv3x3s1_int8`` (``:159``; Pallas kernel ``_dw_kernel``
``:74``).  Both entry points launch one hand-written kernel,
``csrc/dw_conv.cu`` (k ∈ {3, 5} and stride ∈ {1, 2} as template
parameters, SAME padding by bounds checks; its header says what bounds it
on an H100 and how the design answers that).  The TPU kernel's channel
padding to 128 lanes, image blocking and stride-2 polyphase split were TPU
layout choices and are not carried over.

On a CPU tensor the entry points run :func:`dw_conv_int8_plain`, the same
function in plain PyTorch; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..common import f32, normalize_2d, normalize_paddings
from . import _build
from .int8_matmul import act_args, epilogue, inv_out_scale

# launches of the CUDA kernel, counted by the wrapper (CPU calls not
# counted): in all, and by stride (the TPU had one kernel for each)
launches = 0
launches_by_stride = {1: 0, 2: 0}


def out_size(h: int, k: int, stride: int) -> int:
    return (h + 2 * ((k - 1) // 2) - k) // stride + 1


# ---- the kernel's tiling (csrc/dw_conv.cu takes these numbers as given) ----

RUN = 7  # output columns a thread computes at a time (P in dw_conv.cu)
# The cost estimate's constants, tested on the card against the plan
# without them by paddle_lite_tpu_torch/tools/dw_plan_study.py (PERF.md).
TILE_COST = 0.2           # a tile's fixed cost (barriers, constants), in units
UNITS_PER_PIECE = 0.05    # a copied piece's cost, in units


class Layout(NamedTuple):
    """The kernel's thread layout and what the card holds of it, as the
    built library reports them (``plt_dw_conv_layout``): threads a block,
    channels a thread owns, blocks an SM holds (the fewest over the
    instantiations of one kernel size), the card's SMs, and the shared
    bytes one block may take while that many blocks share an SM."""
    threads: int
    channels: int
    blocks_per_sm: int
    sms: int
    smem_per_block: int


def layout(k: int, device: Optional[int] = None) -> Layout:
    """:class:`Layout` of the k×k kernel on CUDA device `device` (the
    current one by default)."""
    return _layout(torch.cuda.current_device() if device is None else device, k)


@functools.lru_cache(maxsize=None)
def _layout(device: int, k: int) -> Layout:
    import ctypes

    with torch.cuda.device(device):
        lib = _build.load("dw_conv")
        vals = [ctypes.c_int() for _ in Layout._fields]
        _build.check(lib.plt_dw_conv_layout(k, *[ctypes.byref(v) for v in vals]),
                     "dw_conv layout")
    return Layout(*(v.value for v in vals))


class Plan(NamedTuple):
    """One launch's tiling.  A tile is ``images_per_block`` images × ``th``
    output rows × ``tw`` output columns (runs of RUN columns, one a thread
    at a time) × ``cv`` channels; its input halo,
    ((th-1)·s+k) rows × ((tw-1)·s+k) columns × cv bytes an image, is copied
    into shared memory in ``vec_bytes`` pieces (rows :func:`row_stride`
    bytes apart).  ``grid`` counts the tiles as (row tiles × column tiles ×
    channel chunks, groups of images); the kernel walks them with as many
    resident blocks as the card holds, two tiles' copies in flight."""
    th: int
    tw: int
    cv: int
    vec_bytes: int
    images_per_block: int
    smem_bytes: int
    grid: Tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def vec_bytes(c: int) -> int:
    """The widest copy that C's rows allow: 16, 8, 4 or 1 bytes."""
    return next(v for v in (16, 8, 4, 1) if c % v == 0)


def _channel_chunk(c: int, vec: int, lay: Layout) -> int:
    """Channels a tile takes (at most 256): a multiple of a thread's
    channels and of `vec`, chosen for the fewest idle lanes (past C, or
    threads left over when the block's threads are not a multiple of the
    channel groups), reads of whole 32-byte sectors and a group count that
    tiles a warp's 32 banks."""
    cpad = _up(c, lay.channels)
    step = max(vec, lay.channels)
    best = None
    for cv in range(step, min(_up(cpad, step), 256) + 1, step):
        g = cv // lay.channels
        lanes = _cdiv(cpad, cv) * cv / cpad
        threads = lay.threads / ((lay.threads // g) * g)
        sectors = 1.0 if cv >= cpad else cv / (32 * _cdiv(cv, 32))
        banks = 1.0 if (32 % g == 0 or g % 32 == 0) else 1.1
        key = (round(lanes * threads * banks / sectors, 4), abs(cv - 64))
        if best is None or key < best[0]:
            best = (key, cv)
    return best[1]


def _halo(th: int, tw: int, k: int, s: int) -> Tuple[int, int]:
    return (th - 1) * s + k, (tw - 1) * s + k


def row_stride(tw: int, cv: int, vec: int, k: int, s: int) -> int:
    """Bytes of one halo row in shared memory: its columns' cv bytes each,
    rounded up to the copy width (at least 4), as dw_conv.cu lays it out."""
    return _up(_halo(1, tw, k, s)[1] * cv, max(vec, 4))


def smem_bytes(th: int, tw: int, cv: int, vec: int, ipb: int, k: int, s: int) -> int:
    """Shared bytes of a block: two buffers, each a tile's halo and its
    constants (k·k·cv weight bytes, cv fp32 scales and biases), and the
    staged int8 output tile."""
    sh, _ = _halo(th, tw, k, s)
    buf = _up(ipb * sh * row_stride(tw, cv, vec, k, s), 16) + _up(k * k * cv, 16) + 8 * cv
    return 2 * buf + ipb * th * tw * cv


def _splits(m: int):
    """The even splits of m items: every distinct ceil(m / parts)."""
    return sorted({_cdiv(m, parts) for parts in range(1, m + 1)})


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, k: int, s: int, lay: Layout) -> Plan:
    """The tiling of one (N, H, W, C) int8 depthwise conv with a k×k kernel
    at stride s, for the kernel's layout on a card (:func:`layout`): pure
    Python, so the CPU tests check it; the kernel checks what it is given
    and refuses a plan it cannot take.

    Among even splits of the rows and runs of RUN columns (whole images,
    several to a tile, where they are small) whose blocks fit
    ``lay.blocks_per_sm`` to an SM, and among those with a tile for every
    SM where there are any, the one with the least estimated time: rounds
    of tiles over the resident blocks, each round as long as the units a
    thread walks in a tile plus the tile's copies (a piece ≈
    UNITS_PER_PIECE of a unit) and fixed cost."""
    oh, ow = out_size(h, k, s), out_size(w, k, s)
    vec = vec_bytes(c)
    cv = _channel_chunk(c, vec, lay)
    ustep = lay.threads // (cv // lay.channels)
    resident = lay.sms * lay.blocks_per_sm

    def cost(th, runs, ipb):
        tw = runs * RUN
        sh, sw = _halo(th, tw, k, s)
        if smem_bytes(th, tw, cv, vec, ipb, k, s) > lay.smem_per_block:
            return None
        tiles = _cdiv(n, ipb) * _cdiv(oh, th) * _cdiv(_cdiv(ow, RUN), runs) * _cdiv(c, cv)
        pieces = (ipb * sh * sw * (cv // vec) + _cdiv(k * k * cv, vec) + 2 * cv
                  + ipb * th * tw * (cv // vec))
        per_tile = (_cdiv(ipb * th * runs, ustep) + TILE_COST
                    + UNITS_PER_PIECE * _cdiv(pieces, lay.threads))
        return tiles < lay.sms, _cdiv(tiles, resident) * per_tile, tiles

    best = None
    runs_all = _cdiv(ow, RUN)
    for runs in _splits(runs_all):
        shapes = [(th, 1) for th in _splits(oh)]
        if runs == runs_all:
            shapes += [(oh, ipb) for ipb in _splits(n) if ipb > 1]
        for th, ipb in shapes:
            got = cost(th, runs, ipb)
            if got is not None and (best is None or got < best[0]):
                best = (got, th, runs, ipb)
    _, th, runs, ipb = best if best is not None else (None, 1, 1, 1)
    tw = runs * RUN
    grid = (_cdiv(oh, th) * _cdiv(ow, tw) * _cdiv(c, cv), _cdiv(n, ipb))
    return Plan(th, tw, cv, vec, ipb, smem_bytes(th, tw, cv, vec, ipb, k, s), grid)


def dw_conv_int8_plain(x, w, eff_scale, bias=None, *, stride: int = 1,
                       act=None, act_attrs=None, out_scale=None) -> torch.Tensor:
    """Plain PyTorch version: an fp32 grouped conv (exact: ≤25 int8 products
    per output stay below 2^24) rounded to the integer accumulator, then the
    identical epilogue."""
    k, c = w.shape[0], w.shape[3]
    xn = x.permute(0, 3, 1, 2).to(torch.float32)
    wn = w.to(torch.float32).permute(3, 2, 0, 1)  # (C, 1, k, k)
    acc = F.conv2d(xn, wn, stride=stride, padding=(k - 1) // 2, groups=c)
    acc = torch.round(acc).permute(0, 2, 3, 1)
    return epilogue(acc, eff_scale, bias, act, act_attrs, out_scale)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"dw_conv_int8: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def dw_conv_int8(
    x: torch.Tensor,  # (N, H, W, C) int8
    w: torch.Tensor,  # (k, k, 1, C) int8
    eff_scale,  # (C,) f32 = s_x * s_w per channel
    bias: Optional[torch.Tensor] = None,  # (C,) f32
    *,
    stride: int = 1,
    act: Optional[str] = None,
    act_attrs: Optional[dict] = None,
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """General int8 depthwise conv: k ∈ {3, 5}, stride ∈ {1, 2}, SAME pad."""
    if x.device.type == "cpu":
        return dw_conv_int8_plain(x, w, eff_scale, bias, stride=stride,
                                  act=act, act_attrs=act_attrs,
                                  out_scale=out_scale)
    global launches
    dev = x.device
    _build.require_current_device(dev, "dw_conv_int8")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError("dw_conv_int8: x must be NHWC and w (k, k, 1, C)")
    n, h, wd, c = x.shape
    k = w.shape[0]
    if k not in (3, 5) or stride not in (1, 2):
        raise ValueError(f"dw_conv_int8: k={k}, stride={stride} not in "
                         f"k∈{{3,5}}, stride∈{{1,2}}")
    _check(x, "x", torch.int8, (n, h, wd, c), dev)
    _check(w, "w", torch.int8, (k, k, 1, c), dev)
    scale = f32(eff_scale, dev).expand(c).contiguous()
    if bias is not None:
        _check(bias, "bias", torch.float32, (c,), dev)
    act_c = act_args(act, act_attrs)
    oh, ow = out_size(h, k, stride), out_size(wd, k, stride)
    p = plan(n, h, wd, c, k, stride, layout(k, dev.index))
    for t, name in ((x, "x"), (w, "w")):
        if t.data_ptr() % p.vec_bytes:
            raise ValueError(f"dw_conv_int8: {name}'s data is not {p.vec_bytes}-byte "
                             f"aligned, as the plan's copies need for C={c}")
    out = torch.empty((n, oh, ow, c), device=dev,
                      dtype=torch.float32 if out_scale is None else torch.int8)
    lib = _build.load("dw_conv")
    rc = lib.plt_dw_conv(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        n, h, wd, c, oh, ow, k, stride, *act_c, int(out_scale is not None),
        0.0 if out_scale is None else inv_out_scale(out_scale),
        p.th, p.tw, p.cv, p.vec_bytes, p.images_per_block,
        p.smem_bytes, *p.grid, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "dw_conv")
    launches += 1
    launches_by_stride[stride] += 1
    return out


def dw_conv3x3s1_int8(x, w, eff_scale, bias=None, *, act=None,
                      act_attrs=None, out_scale=None) -> torch.Tensor:
    """3x3 / stride-1 entry point (``dw_conv3x3s1_int8`` there); the same
    kernel as :func:`dw_conv_int8` — the TPU version differed only in how it
    blocked images per grid step."""
    if tuple(w.shape[:3]) != (3, 3, 1):
        raise ValueError(f"dw_conv3x3s1_int8: w must be (3, 3, 1, C), got "
                         f"{tuple(w.shape)}")
    return dw_conv_int8(x, w, eff_scale, bias, stride=1, act=act,
                        act_attrs=act_attrs, out_scale=out_scale)


def supported(op_attrs, x_shape, w_shape) -> bool:
    """3x3 / stride 1 / SAME / no dilation / channel multiplier 1: the
    domain of ``dw_conv3x3s1_int8`` and of the fused dw+pw kernel
    (``supported`` ``:182-199`` there; the ``dw_pw_fuse`` pass's gate)."""
    if w_shape[-1] != x_shape[-1]:  # multiplier != 1
        return False
    return (
        tuple(w_shape[:2]) == (3, 3)
        and normalize_2d(op_attrs.get("strides", (1, 1))) == (1, 1)
        and normalize_2d(op_attrs.get("dilations", (1, 1))) == (1, 1)
        and normalize_paddings(op_attrs.get("paddings", (0, 0))) == ((1, 1), (1, 1))
    )


def supported_general(op_attrs, x_shape, w_shape) -> bool:
    """Semantic eligibility (``supported_general`` ``:390-417`` there): square
    k ∈ {3, 5}, uniform stride ∈ {1, 2}, SAME padding, no dilation, channel
    multiplier 1.  The TPU's VMEM slab cap (``:402-416``) is not a limit of
    this kernel and is left out."""
    kh, kw = w_shape[0], w_shape[1]
    if w_shape[-1] != x_shape[-1]:  # multiplier != 1
        return False
    strides = normalize_2d(op_attrs.get("strides", (1, 1)))
    dil = normalize_2d(op_attrs.get("dilations", (1, 1)))
    pads = normalize_paddings(op_attrs.get("paddings", (0, 0)))
    p = (kh - 1) // 2
    return (
        kh == kw and kh in (3, 5)
        and strides in ((1, 1), (2, 2))
        and dil == (1, 1)
        and pads == ((p, p), (p, p))
    )
