"""Shared helpers for op implementations.

Port of ``paddle_lite_tpu/ops/common.py``: activations, the int8
quantize / dequantize transforms (``lite/backends/arm/math/type_trans.cc``
analog) and the int32 → fp32 → int8 GEMM epilogue, on torch tensors.

Rounding: ``torch.round`` rounds half to even, as ``jnp.round`` does
(``common.py:107`` there).  Scales enter as float32 tensors on the tensor's
device: dividing a CUDA tensor by a Python scalar makes PyTorch multiply by
its reciprocal instead, which is not the reference's arithmetic.

Promotion: a per-tensor scale is a 0-dim float32 tensor, and PyTorch keeps
a bf16 operand's dtype against a 0-dim float32 one, where ``jnp`` promotes
a bf16 array against a float32 array to float32.  So every helper that
meets a bf16 value (an island value, ``graph.meta["island_dtype"]``)
upcasts it first, as jnp would (:func:`upcast`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

INT8_MIN, INT8_MAX = -127, 127  # symmetric: -127..127, matching reference


def upcast(x: torch.Tensor) -> torch.Tensor:
    """`x` as jnp promotes it against a float32 array: a bf16 or fp16
    tensor becomes float32; float32, float64 and integer tensors are
    returned as they are (their arithmetic with a float32 scale already
    gives jnp's dtype)."""
    return x.to(torch.float32) if x.dtype in (torch.bfloat16, torch.float16) else x


def f32(value, device: torch.device) -> torch.Tensor:
    """`value` (scalar or array) as a float32 tensor on `device`."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    arr = np.asarray(value, dtype=np.float32)
    if arr.ndim == 0:
        return torch.full((), float(arr), dtype=torch.float32, device=device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# ---- activations ----------------------------------------------------------

# the parameters of the activations the CUDA epilogue computes, in the order
# it takes them, with the reference's defaults (``common.py:45-61`` there)
ACT_PARAMS = {
    "leaky_relu": (("alpha", 0.01),),
    "hard_swish": (("threshold", 6.0), ("scale", 6.0), ("offset", 3.0)),
    "hard_sigmoid": (("slope", 0.2), ("offset", 0.5)),
}


def act_params(act: Optional[str], attrs=None) -> Tuple[float, ...]:
    """The parameters of `act` from its attrs, defaults filled in."""
    attrs = attrs or {}
    return tuple(float(attrs.get(k, d)) for k, d in ACT_PARAMS.get(act, ()))


def apply_activation(x: torch.Tensor, act: Optional[str], attrs=None) -> torch.Tensor:
    """Fused-activation epilogue (``common.apply_activation`` there).

    hard_swish divides by its scale as a tensor on x's device: PyTorch
    turns a CUDA tensor divided by a Python scalar into a multiply by the
    reciprocal, which is not the reference's (nor the kernels') division."""
    if act is None or act == "" or act == "linear":
        return x
    attrs = attrs or {}
    if act == "relu":
        return torch.relu(x)
    if act == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if act == "leaky_relu":
        (alpha,) = act_params(act, attrs)
        return torch.where(x >= 0, x, alpha * x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "tanh":
        return torch.tanh(x)
    if act == "swish":
        beta = attrs.get("beta", 1.0)
        return x * torch.sigmoid(beta * x)
    if act == "hard_swish":
        thr, scl, off = act_params(act, attrs)
        return x * torch.clamp(x + off, 0.0, thr) / f32(scl, x.device)
    if act == "hard_sigmoid":
        slope, off = act_params(act, attrs)
        return torch.clamp(slope * x + off, 0.0, 1.0)
    if act == "relu_clipped":
        return torch.clamp(x, 0.0, attrs.get("Relu_clipped_coef", 6.0))
    if act == "gelu":
        approx = "tanh" if attrs.get("approximate", False) else "none"
        return F.gelu(x, approximate=approx)
    if act == "exp":
        return torch.exp(x)
    if act == "abs":
        return torch.abs(x)
    if act == "sqrt":
        return torch.sqrt(x)
    if act == "rsqrt":
        return torch.rsqrt(x)
    if act == "square":
        return torch.square(x)
    if act == "log":
        return torch.log(x)
    if act == "floor":
        return torch.floor(x)
    if act == "mish":
        return x * torch.tanh(F.softplus(x))
    if act == "elu":
        return F.elu(x, alpha=attrs.get("alpha", 1.0))
    if act == "softplus":
        return F.softplus(x)
    if act == "softsign":
        return x / (1.0 + torch.abs(x))
    if act == "silu":
        return F.silu(x)
    if act == "reciprocal":
        return 1.0 / x
    raise ValueError(f"unknown activation {act!r}")


# ---- quantization ---------------------------------------------------------

def _broadcast_scale(scale, x: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    s = f32(scale, x.device)
    if axis is not None and s.ndim == 1:
        shape = [1] * x.ndim
        shape[axis] = -1
        s = s.reshape(shape)
    return s


def quantize(x: torch.Tensor, scale, axis: Optional[int] = None) -> torch.Tensor:
    """fp32 -> int8: round(x / scale) half to even, saturate to ±127.  A
    bf16 `x` is divided in float32, as jnp divides it by a float32 scale."""
    x = upcast(x)
    q = torch.round(x / _broadcast_scale(scale, x, axis))
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale, axis: Optional[int] = None) -> torch.Tensor:
    """int8 -> fp32."""
    return q.to(torch.float32) * _broadcast_scale(scale, q, axis)


def requant_epilogue(
    acc_i32: torch.Tensor,
    *,
    effective_scale,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    act_attrs=None,
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """int32 accum → fp32 scale → +bias → act → (optional) int8 requant."""
    y = acc_i32.to(torch.float32) * f32(effective_scale, acc_i32.device)
    if bias is not None:
        y = y + upcast(bias)
    y = apply_activation(y, act, act_attrs)
    if out_scale is not None:
        return quantize(y, out_scale)
    return y


def effective_conv_scale(in_scale: float, weight_scales) -> np.ndarray:
    """Fold s_x * s_w[c] once, in numpy float32, as the reference does."""
    return np.float32(in_scale) * np.asarray(weight_scales, np.float32)


# ---- shape utilities ------------------------------------------------------

def normalize_2d(v, name: str = "value") -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    t = tuple(int(x) for x in v)
    if len(t) == 1:
        return (t[0], t[0])
    if len(t) != 2:
        raise ValueError(f"{name} must have 1-2 entries, got {v}")
    return t


def normalize_paddings(paddings) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Paddle conv paddings: [h, w] or [h0, h1, w0, w1] → ((h0,h1),(w0,w1))."""
    if isinstance(paddings, str):
        raise ValueError("string padding handled by caller")
    p = [int(x) for x in np.asarray(paddings).reshape(-1)]
    if len(p) == 1:
        p = p * 4
    if len(p) == 2:
        return ((p[0], p[0]), (p[1], p[1]))
    if len(p) == 4:
        return ((p[0], p[1]), (p[2], p[3]))
    raise ValueError(f"bad paddings {paddings}")


def conv_out_size(in_size: int, k: int, stride: int, pad: Tuple[int, int], dilation: int) -> int:
    eff_k = dilation * (k - 1) + 1
    return (in_size + pad[0] + pad[1] - eff_k) // stride + 1
