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

from typing import Optional

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
    out = torch.empty((n, oh, ow, c), device=dev,
                      dtype=torch.float32 if out_scale is None else torch.int8)
    lib = _build.load("dw_conv")
    rc = lib.plt_dw_conv(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        n, h, wd, c, oh, ow, k, stride, *act_c, int(out_scale is not None),
        0.0 if out_scale is None else inv_out_scale(out_scale),
        torch.cuda.current_stream(dev).cuda_stream)
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
