"""Fused int8 depthwise (3x3, stride 1) + pointwise (1x1) block.

Port of ``paddle_lite_tpu/ops/kernels/dw_pw_fused.py`` (``fused_dw_pw_int8``
``:162``; Pallas kernel ``_kernel`` ``:41``).  On a CUDA tensor
:func:`fused_dw_pw_int8` launches the hand-written kernel
``csrc/dw_pw_fused.cu``: one block per band of output rows keeps the halo
slab and the int8 depthwise output in shared memory and runs the pointwise
product through ``mma.sync`` (its header says what bounds it on an H100 and
how the design answers that).  The TPU kernel's grid over images, its row
chunks and its 128-lane output blocks were VMEM and MXU choices and are not
carried over.  On a CPU tensor it runs :func:`fused_dw_pw_int8_plain`, the
same function in plain PyTorch; there is no fallback from one to the other.

The arithmetic is that of :func:`.depthwise.dw_conv_int8` (with its int8
requant by ``fp32(1/dw_out_scale)``, ``dw_pw_fused.py:73`` there) followed by
:func:`.int8_matmul.int8_matmul`, so on identical inputs the fused kernel
equals the unfused pair of kernels bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common import f32
from . import _build
from .depthwise import dw_conv_int8_plain
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


def tiling(h: int, w: int, c: int):
    """(R, TW, shared bytes): the band of rows and strip of columns one
    block of the kernel takes at this shape (needs the built library)."""
    r, tw, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    rc = _build.load("dw_pw_fused").plt_dw_pw_fused_tiling(
        h, w, c, ctypes.byref(r), ctypes.byref(tw), ctypes.byref(smem))
    _build.check(rc, "dw_pw_fused tiling")
    return r.value, tw.value, smem.value


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
    out = torch.empty((n, h, w, o), device=dev,
                      dtype=torch.float32 if pw_out_scale is None else torch.int8)
    vec = int(c % 16 == 0 and x.data_ptr() % 16 == 0
              and pw_w_nk.data_ptr() % 16 == 0)
    lib = _build.load("dw_pw_fused")
    rc = lib.plt_dw_pw_fused(
        x.data_ptr(), dw_w.data_ptr(), dw_scale.data_ptr(),
        None if dw_bias is None else dw_bias.data_ptr(), *dw_a,
        inv_out_scale(dw_out_scale), pw_w_nk.data_ptr(), pw_scale.data_ptr(),
        None if pw_bias is None else pw_bias.data_ptr(), *pw_a,
        int(pw_out_scale is not None),
        0.0 if pw_out_scale is None else inv_out_scale(pw_out_scale),
        out.data_ptr(), n, h, w, c, o, vec,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "dw_pw_fused")
    launches += 1
    return out
