"""int8 GEMM with fused scale / bias / activation / requant epilogue.

Port of ``paddle_lite_tpu/ops/kernels/int8_matmul.py`` (``int8_matmul``
``:169``; Pallas kernel ``_matmul_kernel`` ``:43``, epilogue ``_epilogue``
``:31``).  On a CUDA tensor :func:`int8_matmul` launches the hand-written
kernel ``csrc/int8_gemm.cu`` (``mma.sync`` s8·s8→s32, epilogue in
registers; its header says what bounds it on an H100 and how the design
answers that).  On a CPU tensor it runs :func:`int8_matmul_plain`, the same
function in plain PyTorch.  There is no fallback from one to the other.

Weights: the kernel reads B transposed, (N, K) with K contiguous.  Callers
that run the same weight many times pass it repacked once as ``w_nk`` (the
reference's ``PrepareForRun`` weight-repack analog, done by the op impl on
its first run); otherwise the wrapper transposes per call.

Requant: the Pallas epilogue multiplies by ``1.0 / out_scale`` computed in
Python double precision and applied as an fp32 constant
(``int8_matmul.py:38``), so the wrapper passes
``float(np.float32(1.0 / out_scale))``, never ``1 / out_scale`` in fp32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..common import act_params, apply_activation, f32
from . import _build

# launches of the CUDA kernel, counted by the wrapper (CPU calls not counted)
launches = 0

# the activations of the CUDA epilogue (``csrc/epilogue.cuh``, ``plt::Act``):
# those whose fp32 arithmetic the kernels reproduce exactly.  sigmoid,
# swish, tanh, gelu and the other transcendental ones are not here.
ACTS = {None: 0, "": 0, "linear": 0, "relu": 1, "relu6": 2, "leaky_relu": 3,
        "hard_swish": 4, "hard_sigmoid": 5}


def act_code(act: Optional[str]) -> int:
    if act not in ACTS:
        raise NotImplementedError(
            f"activation {act!r} is not in the CUDA epilogue (supported: "
            f"{', '.join(a for a in ACTS if a)}, none)")
    return ACTS[act]


def act_args(act: Optional[str], act_attrs=None):
    """(code, p0, p1, p2): the activation as the C entry points take it,
    each parameter rounded once to fp32 as the reference applies it."""
    p = act_params(act, act_attrs) + (0.0, 0.0, 0.0)
    return (act_code(act),) + tuple(float(np.float32(v)) for v in p[:3])


def inv_out_scale(out_scale: float) -> float:
    """1/out_scale rounded once from double to fp32, as the Pallas epilogue
    applies it."""
    return float(np.float32(1.0 / float(out_scale)))


def epilogue(acc: torch.Tensor, eff_scale, bias, act, act_attrs,
             out_scale) -> torch.Tensor:
    """The kernels' epilogue in plain PyTorch: acc (integer-valued fp32)
    · scale (+ bias) → act → fp32, or int8 rint(y · inv) clipped to ±127."""
    y = acc * f32(eff_scale, acc.device)
    if bias is not None:
        y = y + bias.to(torch.float32)
    y = apply_activation(y, act, act_attrs)
    if out_scale is None:
        return y
    q = torch.round(y * f32(inv_out_scale(out_scale), acc.device))
    return torch.clamp(q, -127, 127).to(torch.int8)


def int8_matmul_plain(x_q, w_q, eff_scale, bias=None, *, act=None,
                      act_attrs=None, out_scale=None) -> torch.Tensor:
    """Plain PyTorch version: a float64 matmul gives the exact int32
    accumulator, then the identical epilogue as separate torch ops."""
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.float32)
    return epilogue(acc, eff_scale, bias, act, act_attrs, out_scale)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"int8_matmul: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def int8_matmul(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    eff_scale,
    bias: Optional[torch.Tensor] = None,
    *,
    act: Optional[str] = None,
    act_attrs: Optional[dict] = None,
    out_scale: Optional[float] = None,
    w_nk: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out = epilogue((x_q @ w_q).i32) — fp32 out, or int8 when
    ``out_scale`` is given.  ``x_q`` (M, K) int8, ``w_q`` (K, N) int8,
    ``eff_scale`` = s_x·s_w per output column ((N,) or scalar), ``bias``
    fp32 (N,) or None."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q, eff_scale, bias, act=act,
                                 act_attrs=act_attrs, out_scale=out_scale)
    global launches
    dev = x_q.device
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)} do not compose")
    m, k = x_q.shape
    n = w_q.shape[1]
    if w_nk is None:
        _check(w_q, "w_q", torch.int8, (k, n), dev)
        w_nk = w_q.t().contiguous()
    _check(x_q, "x_q", torch.int8, (m, k), dev)
    _check(w_nk, "w_nk", torch.int8, (n, k), dev)
    scale = f32(eff_scale, dev).expand(n).contiguous()
    if bias is not None:
        _check(bias, "bias", torch.float32, (n,), dev)
    act_c = act_args(act, act_attrs)
    out = torch.empty((m, n), device=dev,
                      dtype=torch.float32 if out_scale is None else torch.int8)
    vec = int(k % 16 == 0 and x_q.data_ptr() % 16 == 0
              and w_nk.data_ptr() % 16 == 0)
    lib = _build.load("int8_gemm")
    rc = lib.plt_int8_gemm(
        x_q.data_ptr(), w_nk.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, n, k, *act_c, int(out_scale is not None),
        0.0 if out_scale is None else inv_out_scale(out_scale), vec,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "int8_gemm")
    launches += 1
    return out
