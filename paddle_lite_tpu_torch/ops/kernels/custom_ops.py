"""The kernel entry points as PyTorch custom ops: ``plt::int8_gemm``,
``plt::int8_conv`` (the GEMM's gathering launch), ``plt::dw_conv``,
``plt::dw_pw_fused`` and ``plt::nms_keep``.

Every ``"cuda"`` impl reaches its kernel through :func:`gemm`, :func:`conv`,
:func:`dw_conv`, :func:`fused` and :func:`nms_keep`.  Under
``torch.export`` (``formats/aot.py``) they emit the custom op, so the
traced program holds each kernel as one opaque op, where the ctypes launch
inside the wrapper could not be traced.  Otherwise they call the wrapper
itself: the custom op's dispatch costs the eager loop 70-150 µs a kernel
call on the host (SSD-300 b32's eager request, 47 kernel calls, 14.1-15.4
ms through the wrappers and 17.5-22.3 through the ops in two runs on an
H100 80GB HBM3 at 700 W; ``chip_smoke.py`` phase 15b measures it); the
compiled path replays CUDA graphs and pays it in neither case.

Each op's body is the wrapper itself (:func:`~.int8_matmul.int8_matmul`,
:func:`~.int8_matmul.int8_conv`, :func:`~.depthwise.dw_conv_int8`,
:func:`~.dw_pw_fused.fused_dw_pw_int8`, :func:`~.nms.nms_keep_scores`): on
a CUDA tensor it launches the kernel and counts the launch, on a CPU
tensor it runs the plain version.  Each op's fake (``register_fake``) gives
the output's shape and dtype only, for tracing.  The ops register when
``paddle_lite_tpu_torch.ops`` is imported, so a loaded exported program
finds them.

The schemas take tensors, numbers and strings: an activation's attributes
travel as sorted JSON (:func:`attrs_json`), a requant scale as a float or
None, the GEMM's residual as a tensor or None with its scale, a gathering
conv's window as eight ints (kh, kw, the strides, the paddings top, bottom,
left, right).
"""

from __future__ import annotations

import json
from typing import List, Optional

import torch

from . import depthwise, dw_pw_fused, int8_matmul, nms


def attrs_json(attrs: Optional[dict]) -> str:
    """An activation's attributes as the ops take them ("" for none)."""
    return json.dumps(attrs, sort_keys=True) if attrs else ""


def _attrs(s: str) -> Optional[dict]:
    return json.loads(s) if s else None


def _scale(v) -> Optional[float]:
    return None if v is None else float(v)


@torch.library.custom_op("plt::int8_gemm", mutates_args=())
def _int8_gemm(x: torch.Tensor, w: torch.Tensor, eff_scale: torch.Tensor,
               bias: Optional[torch.Tensor], w_nk: Optional[torch.Tensor],
               act: Optional[str], act_attrs: str,
               out_scale: Optional[float], residual: Optional[torch.Tensor],
               residual_scale: Optional[float]) -> torch.Tensor:
    return int8_matmul.int8_matmul(x, w, eff_scale, bias, act=act,
                                   act_attrs=_attrs(act_attrs), out_scale=out_scale,
                                   w_nk=w_nk, residual=residual,
                                   residual_scale=residual_scale)


@_int8_gemm.register_fake
def _(x, w, eff_scale, bias, w_nk, act, act_attrs, out_scale, residual, residual_scale):
    return x.new_empty((x.shape[0], w.shape[1]),
                       dtype=torch.float32 if out_scale is None else torch.int8)


def _window(window: List[int]) -> dict:
    """A gathering conv's window as :func:`~.int8_matmul.int8_conv` takes it."""
    kh, kw, sh, sw, pt, pb, pl, pr = window
    return dict(kh=kh, kw=kw, strides=(sh, sw), paddings=(pt, pb, pl, pr))


@torch.library.custom_op("plt::int8_conv", mutates_args=())
def _int8_conv(x: torch.Tensor, w: torch.Tensor, eff_scale: torch.Tensor,
               bias: Optional[torch.Tensor], w_nk: Optional[torch.Tensor],
               window: List[int], act: Optional[str], act_attrs: str,
               out_scale: Optional[float]) -> torch.Tensor:
    return int8_matmul.int8_conv(x, w, eff_scale, bias, **_window(window), act=act,
                                 act_attrs=_attrs(act_attrs), out_scale=out_scale, w_nk=w_nk)


@_int8_conv.register_fake
def _(x, w, eff_scale, bias, w_nk, window, act, act_attrs, out_scale):
    g = int8_matmul.conv_geom(x.shape, **_window(window))
    return x.new_empty((g.n, g.oh, g.ow, w.shape[1]),
                       dtype=torch.float32 if out_scale is None else torch.int8)


@torch.library.custom_op("plt::dw_conv", mutates_args=())
def _dw_conv(x: torch.Tensor, w: torch.Tensor, eff_scale: torch.Tensor,
             bias: Optional[torch.Tensor], stride: int, act: Optional[str],
             act_attrs: str, out_scale: Optional[float]) -> torch.Tensor:
    return depthwise.dw_conv_int8(x, w, eff_scale, bias, stride=stride, act=act,
                                  act_attrs=_attrs(act_attrs), out_scale=out_scale)


@_dw_conv.register_fake
def _(x, w, eff_scale, bias, stride, act, act_attrs, out_scale):
    n, h, wd, c = x.shape
    k = w.shape[0]
    return x.new_empty((n, depthwise.out_size(h, k, stride), depthwise.out_size(wd, k, stride),
                        c), dtype=torch.float32 if out_scale is None else torch.int8)


@torch.library.custom_op("plt::dw_pw_fused", mutates_args=())
def _dw_pw_fused(x: torch.Tensor, dw_w: torch.Tensor, dw_eff: torch.Tensor,
                 dw_bias: Optional[torch.Tensor], dw_out_scale: float,
                 pw_w: torch.Tensor, pw_eff: torch.Tensor,
                 pw_bias: Optional[torch.Tensor], pw_w_nk: Optional[torch.Tensor],
                 dw_act: Optional[str], dw_act_attrs: str, pw_act: Optional[str],
                 pw_act_attrs: str, pw_out_scale: Optional[float]) -> torch.Tensor:
    return dw_pw_fused.fused_dw_pw_int8(
        x, dw_w, dw_eff, dw_bias, dw_out_scale, pw_w, pw_eff, pw_bias,
        dw_act=dw_act, dw_act_attrs=_attrs(dw_act_attrs), pw_act=pw_act,
        pw_act_attrs=_attrs(pw_act_attrs), pw_out_scale=pw_out_scale, pw_w_nk=pw_w_nk)


@_dw_pw_fused.register_fake
def _(x, dw_w, dw_eff, dw_bias, dw_out_scale, pw_w, pw_eff, pw_bias, pw_w_nk,
      dw_act, dw_act_attrs, pw_act, pw_act_attrs, pw_out_scale):
    n, h, w, _ = x.shape
    return x.new_empty((n, h, w, pw_w.shape[-1]),
                       dtype=torch.float32 if pw_out_scale is None else torch.int8)


@torch.library.custom_op("plt::nms_keep", mutates_args=())
def _nms_keep(boxes: torch.Tensor, scores: torch.Tensor, iou_t: float, score_t: float,
              iou_form: str) -> torch.Tensor:
    return nms.nms_keep_scores(boxes, scores, iou_t=iou_t, score_t=score_t,
                               iou_form=iou_form)


@_nms_keep.register_fake
def _(boxes, scores, iou_t, score_t, iou_form):
    return scores.new_empty(scores.shape, dtype=torch.float32)


# ---- the calls the "cuda" impls make: the wrapper, or under torch.export
# the custom op ----------------------------------------------------------------

def gemm(x, w, eff_scale, bias=None, *, act=None, act_attrs=None, out_scale=None,
         w_nk=None, residual=None, residual_scale=None) -> torch.Tensor:
    """``plt::int8_gemm``: :func:`~.int8_matmul.int8_matmul`'s arguments."""
    if not torch.compiler.is_exporting():
        return int8_matmul.int8_matmul(x, w, eff_scale, bias, act=act, act_attrs=act_attrs,
                                       out_scale=out_scale, w_nk=w_nk, residual=residual,
                                       residual_scale=residual_scale)
    return torch.ops.plt.int8_gemm(x, w, eff_scale, bias, w_nk, act, attrs_json(act_attrs),
                                   _scale(out_scale), residual, _scale(residual_scale))


def conv(x, w, eff_scale, bias=None, *, kh, kw, strides, paddings, act=None,
         act_attrs=None, out_scale=None, w_nk=None) -> torch.Tensor:
    """``plt::int8_conv``: :func:`~.int8_matmul.int8_conv`'s arguments."""
    if not torch.compiler.is_exporting():
        return int8_matmul.int8_conv(x, w, eff_scale, bias, kh=kh, kw=kw, strides=strides,
                                     paddings=paddings, act=act, act_attrs=act_attrs,
                                     out_scale=out_scale, w_nk=w_nk)
    g = int8_matmul.conv_geom(x.shape, kh, kw, strides, paddings)
    return torch.ops.plt.int8_conv(x, w, eff_scale, bias, w_nk,
                                   [g.kh, g.kw, g.sh, g.sw, g.pt, g.pb, g.pl, g.pr], act,
                                   attrs_json(act_attrs), _scale(out_scale))


def dw_conv(x, w, eff_scale, bias=None, *, stride=1, act=None, act_attrs=None,
            out_scale=None) -> torch.Tensor:
    """``plt::dw_conv``: :func:`~.depthwise.dw_conv_int8`'s arguments."""
    if not torch.compiler.is_exporting():
        return depthwise.dw_conv_int8(x, w, eff_scale, bias, stride=stride, act=act,
                                      act_attrs=act_attrs, out_scale=out_scale)
    return torch.ops.plt.dw_conv(x, w, eff_scale, bias, int(stride), act,
                                 attrs_json(act_attrs), _scale(out_scale))


def fused(x, dw_w, dw_eff, dw_bias, dw_out_scale, pw_w, pw_eff, pw_bias, *, dw_act=None,
          dw_act_attrs=None, pw_act=None, pw_act_attrs=None, pw_out_scale=None,
          pw_w_nk=None) -> torch.Tensor:
    """``plt::dw_pw_fused``: :func:`~.dw_pw_fused.fused_dw_pw_int8`'s
    arguments."""
    if not torch.compiler.is_exporting():
        return dw_pw_fused.fused_dw_pw_int8(
            x, dw_w, dw_eff, dw_bias, dw_out_scale, pw_w, pw_eff, pw_bias, dw_act=dw_act,
            dw_act_attrs=dw_act_attrs, pw_act=pw_act, pw_act_attrs=pw_act_attrs,
            pw_out_scale=pw_out_scale, pw_w_nk=pw_w_nk)
    return torch.ops.plt.dw_pw_fused(
        x, dw_w, dw_eff, dw_bias, float(dw_out_scale), pw_w, pw_eff, pw_bias, pw_w_nk,
        dw_act, attrs_json(dw_act_attrs), pw_act, attrs_json(pw_act_attrs),
        _scale(pw_out_scale))


def nms_keep(boxes, scores, *, iou_t, score_t, iou_form="mul") -> torch.Tensor:
    """``plt::nms_keep``: :func:`~.nms.nms_keep_scores`'s arguments."""
    if not torch.compiler.is_exporting():
        return nms.nms_keep_scores(boxes, scores, iou_t=iou_t, score_t=score_t,
                                   iou_form=iou_form)
    return torch.ops.plt.nms_keep(boxes, scores, float(iou_t), float(score_t), iou_form)
