"""Sequence ops of the CRNN path under the ``torch`` tag: ``gru``,
``bidirectional_gru`` and ``ctc_greedy_decode``.

Port of ``paddle_lite_tpu/ops/sequence.py`` (``gru_xla`` ``:42-77``,
``ctc_greedy_decode_xla`` ``:205-241``, ``bigru_xla`` ``:243-292``), the
analog of ``lite/operators/gru_op.cc`` and ``lite/backends/arm/math/
gru_utils.h``.  The reference runs them on XLA (it deleted its Pallas GRU,
``sequence.py:294-303``), so they are plain PyTorch here.

Paddle's GRU convention: ``Input`` already holds x_t·W_ih for every step
(3H a step, [update, reset, candidate]; the int8-quantizable ``mul`` before
the op), ``Weight`` is the hidden-to-hidden (H, 3H).  The recurrence is one
Python loop over the time steps; both directions of ``bidirectional_gru``
advance in the same step (fw and the time-reversed bw stacked on a
direction axis, one batched matmul for each of the step's two products), as
the reference's ``vmap`` over the direction does.

Precision.  Gates are computed in float32 from the operands' values.  With
float32 inputs the carry ``h`` is float32.  Under bf16 islands
(``graph.meta["island_dtype"]``) the inputs and weights are bf16, and so
is the carry: each step's h is rounded to bf16 once.  The reference's step
is a chain of bf16 ops that XLA fuses, keeping some of it in float32; the
port keeps the whole step in float32 (bf16 products are exact there), so
the two agree within bf16 rounding of the carry, which the tests state.
The products are float32 matmuls of the bf16 values (exact products,
float32 sums, TF32 off inside ``core/device.fp32_exact``): no bf16 matmul
runs, so cuBLAS's reduced-precision bf16 reduction never applies.

``ctc_greedy_decode`` compacts without a host sync (a cumulative sum of
the kept flags and a scatter), so a CUDA graph can hold it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.registry import OPS
from .common import apply_activation, upcast


def _scan(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor, gate_act: str,
          cand_act: str) -> torch.Tensor:
    """The GRU recurrence over D independent directions: x (D, B, T, 3H)
    and w (D, H, 3H) in float32, h (D, B, H) the initial carry in the
    carry's dtype.  Returns (D, B, T, H) in that dtype.

    A step is ten small kernels at most (two batched matmuls, the gate
    sums and activations in place, ``lerp`` for u·h + (1 − u)·c, and with a
    bf16 carry its rounding into the output and the fp32 copy the next
    step reads): the step inputs are split and laid out time-major once,
    so that no step copies a strided slice."""
    hd = h.shape[-1]
    w_g, w_c = w[..., :2 * hd].contiguous(), w[..., 2 * hd:].contiguous()
    xt = x.permute(2, 0, 1, 3)  # (T, D, B, 3H)
    xg, xc = xt[..., :2 * hd].contiguous(), xt[..., 2 * hd:].contiguous()
    out = h.new_empty((x.shape[2],) + tuple(h.shape))  # (T, D, B, H)
    hf = upcast(h)
    for t in range(x.shape[2]):
        g = apply_activation(torch.bmm(hf, w_g).add_(xg[t]), gate_act)
        u, r = g[..., :hd], g[..., hd:]
        c = apply_activation(torch.bmm(r * hf, w_c).add_(xc[t]), cand_act)
        if out.dtype == torch.float32:
            hf = torch.lerp(c, hf, u, out=out[t])  # u·h + (1 − u)·c
        else:  # the carry rounded to its dtype once a step
            hf = upcast(out[t].copy_(torch.lerp(c, hf, u)))
    return out.permute(1, 2, 0, 3)


def _with_bias(x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x + bias in x's dtype (under islands a bf16 sum, as the reference's),
    then float32 for the recurrence."""
    return upcast(x if bias is None else x + bias)


@OPS.shape_fn("gru")
def gru_shape(attrs, in_shapes):
    b, t, three_h = in_shapes[0]
    return [(b, t, three_h // 3)]


@OPS.kernel("gru", "torch")
def gru_torch(ctx, op, ins):
    x = ins["Input"][0]  # (B, T, 3H) input projections
    w = ins["Weight"][0]  # (H, 3H)
    h0 = ins.get("H0", [None])[0]
    attrs = op.attrs
    b, _, three_h = x.shape
    xs = _with_bias(x, ins.get("Bias", [None])[0])
    if attrs.get("is_reverse"):
        xs = torch.flip(xs, dims=(1,))
    init = h0 if h0 is not None else x.new_zeros((b, three_h // 3))
    out = _scan(xs[None], upcast(w)[None], init.to(x.dtype)[None],
                attrs.get("gate_activation", "sigmoid"),
                attrs.get("activation", "tanh"))[0]
    if attrs.get("is_reverse"):
        out = torch.flip(out, dims=(1,))
    return {"Hidden": [out]}


@OPS.shape_fn("bidirectional_gru")
def bigru_shape(attrs, in_shapes):
    b, t, three_h = in_shapes[0]
    return [(b, t, 2 * (three_h // 3))]


@OPS.kernel("bidirectional_gru", "torch")
def bigru_torch(ctx, op, ins):
    x_fw, x_bw = ins["Input"][0], ins["InputRev"][0]  # (B, T, 3H) each
    w_fw, w_bw = ins["WeightFw"][0], ins["WeightBw"][0]  # (H, 3H) each
    attrs = op.attrs
    b, _, three_h = x_fw.shape
    xs = torch.stack([_with_bias(x_fw, ins.get("BiasFw", [None])[0]),
                      torch.flip(_with_bias(x_bw, ins.get("BiasBw", [None])[0]),
                                 dims=(1,))])
    ws = torch.stack([upcast(w_fw), upcast(w_bw)])
    out = _scan(xs, ws, x_fw.new_zeros((2, b, three_h // 3)),
                attrs.get("gate_activation", "sigmoid"),
                attrs.get("activation", "tanh"))
    return {"Hidden": [torch.cat([out[0], torch.flip(out[1], dims=(1,))], dim=-1)]}


@OPS.shape_fn("ctc_greedy_decode")
def ctc_greedy_decode_shape(attrs, in_shapes):
    b, t, _ = in_shapes[0]
    return [(b, t), (b,)]


@OPS.kernel("ctc_greedy_decode", "torch")
def ctc_greedy_decode_torch(ctx, op, ins):
    """Greedy CTC: the first maximal class a step, repeats collapsed,
    blanks (class C−1 unless ``blank``) dropped.  Fixed shapes: (B, T)
    int32 labels padded with −1 and (B,) int32 lengths.  The kept labels
    land at their rank among the kept (a cumulative sum) by one scatter;
    the others at a spare column that is cut off."""
    probs = ins["X"][0]  # (B, T, C)
    blank = int(op.attrs.get("blank", probs.shape[-1] - 1))
    ids = probs.argmax(dim=-1)  # the first maximal index, as jnp.argmax
    b, t = ids.shape
    prev = torch.cat([ids.new_full((b, 1), -1), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev)
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, t)
    out = ids.new_full((b, t + 1), -1).scatter_(1, pos, ids)[:, :t]
    return {"Out": [out.to(torch.int32)],
            "Length": [keep.sum(dim=1, dtype=torch.int32)]}
