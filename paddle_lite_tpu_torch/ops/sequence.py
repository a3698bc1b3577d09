"""Sequence and RNN ops under the ``torch`` tag: ``gru``,
``bidirectional_gru``, ``gru_unit``, ``lstm``, ``im2sequence``,
``ctc_greedy_decode``, the dense ``sequence_*`` ops and ``beam_search``.

Port of ``paddle_lite_tpu/ops/sequence.py`` (``gru_xla`` ``:42-77``,
``lstm_xla`` ``:79-127``, ``im2sequence_xla`` ``:130-149``, the
``sequence_*`` ops ``:156-197`` and ``:329-375``, ``ctc_greedy_decode_xla``
``:205-241``, ``bigru_xla`` ``:243-292``, ``gru_unit_xla`` ``:310-340``,
``beam_search_xla`` ``:385-416``), the analog of
``lite/operators/{gru,lstm,gru_unit,im2sequence,beam_search}_op.cc`` and
``lite/backends/arm/math/gru_utils.h``.  Sequences are dense (B, T, D)
tensors, as there: the LoD raggedness is left to the bucketed batcher.
``lstm`` is a plain loop over the T steps, its gates through
``apply_activation``; ``beam_search`` is one decoder step of fixed shape
(the op a ``while`` decoder repeats), its top-k in ``jax.lax.top_k``'s
order (``detection.topk_stable``).  The reference runs them on XLA (it deleted its Pallas GRU,
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
import torch.nn.functional as F

from ..core.registry import OPS
from .common import apply_activation, f32, upcast
from .detection import topk_stable


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


# ---------------------------------------------------------------------------
# gru_unit, lstm (``sequence.py:310-340``, ``:79-127`` there)
# ---------------------------------------------------------------------------

@OPS.shape_fn("gru_unit")
def gru_unit_shape(attrs, in_shapes):
    b, three_h = in_shapes[0]
    h = three_h // 3
    return [(b, h), (b, h), (b, 2 * h)]


@OPS.kernel("gru_unit", "torch")
def gru_unit_torch(ctx, op, ins):
    """One GRU step, ``gru``'s gate layout: Hidden, ResetHiddenPrev (r·h)
    and Gate ([u, r])."""
    x, h_prev, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    bias = ins.get("Bias", [None])[0]
    gate_act = op.attrs.get("gate_activation", "sigmoid")
    cand_act = op.attrs.get("activation", "tanh")
    h = h_prev.shape[-1]
    if bias is not None:
        x = x + bias
    g = x[:, :2 * h] + h_prev @ w[:, :2 * h]
    u = apply_activation(g[:, :h], gate_act)
    r = apply_activation(g[:, h:], gate_act)
    rh = r * h_prev
    c = apply_activation(x[:, 2 * h:] + rh @ w[:, 2 * h:], cand_act)
    return {"Hidden": [u * h_prev + (1.0 - u) * c], "ResetHiddenPrev": [rh],
            "Gate": [torch.cat([u, r], dim=-1)]}


@OPS.shape_fn("lstm")
def lstm_shape(attrs, in_shapes):
    b, t, four_h = in_shapes[0]
    return [(b, t, four_h // 4), (b, t, four_h // 4)]


@OPS.kernel("lstm", "torch")
def lstm_torch(ctx, op, ins):
    """``Input`` holds x_t·W_ih (4H a step: input, forget, cell, output
    gates), ``Weight`` the hidden-to-hidden (H, 4H); zero initial state;
    Hidden and Cell for every step."""
    x, w = ins["Input"][0], ins["Weight"][0]
    bias = ins.get("Bias", [None])[0]
    a = op.attrs
    b, t, four_h = x.shape
    h = four_h // 4
    if bias is not None:
        x = x + bias.reshape(-1)[:4 * h]
    if a.get("is_reverse"):
        x = torch.flip(x, dims=(1,))
    gate_act = a.get("gate_activation", "sigmoid")
    cell_act = a.get("cell_activation", "tanh")
    cand_act = a.get("candidate_activation", "tanh")
    hs, cs = [], []
    h_prev = c_prev = x.new_zeros((b, h))
    for step in range(t):
        g = x[:, step] + h_prev @ w
        i = apply_activation(g[:, :h], gate_act)
        f = apply_activation(g[:, h:2 * h], gate_act)
        ct = apply_activation(g[:, 2 * h:3 * h], cand_act)
        o = apply_activation(g[:, 3 * h:], gate_act)
        c_prev = f * c_prev + i * ct
        h_prev = o * apply_activation(c_prev, cell_act)
        hs.append(h_prev)
        cs.append(c_prev)
    out_h, out_c = torch.stack(hs, dim=1), torch.stack(cs, dim=1)
    if a.get("is_reverse"):
        out_h, out_c = torch.flip(out_h, dims=(1,)), torch.flip(out_c, dims=(1,))
    return {"Hidden": [out_h], "Cell": [out_c]}


# ---------------------------------------------------------------------------
# im2sequence (``sequence.py:130-149`` there)
# ---------------------------------------------------------------------------

@OPS.shape_fn("im2sequence")
def im2sequence_shape(attrs, in_shapes):
    n, h, w, c = in_shapes[0]
    kh, kw = attrs.get("kernels", [1, 1])
    sh, sw = attrs.get("strides", [1, 1])
    return [(n, ((h - kh) // sh + 1) * ((w - kw) // sw + 1), kh * kw * c)]


@OPS.kernel("im2sequence", "torch")
def im2sequence_torch(ctx, op, ins):
    """NHWC patches, valid padding, one a step in row-major order, each
    flattened channel-major (c, ky, kx) as ``conv_general_dilated_patches``
    lays them out."""
    kh, kw = (int(k) for k in op.attrs.get("kernels", [1, 1]))
    sh, sw = (int(s) for s in op.attrs.get("strides", [1, 1]))
    cols = F.unfold(ins["X"][0].permute(0, 3, 1, 2), (kh, kw), stride=(sh, sw))
    return {"Out": [cols.transpose(1, 2)]}


# ---------------------------------------------------------------------------
# the dense sequence_* ops (``sequence.py:156-197``, ``:329-375`` there)
# ---------------------------------------------------------------------------

def _same(attrs, in_shapes):
    return [in_shapes[0]]


OPS.register("sequence_softmax", infer_shape=_same)
OPS.get("sequence_softmax").impls["torch"] = lambda ctx, op, ins: {
    "Out": [torch.softmax(ins["X"][0], dim=-1)]}
OPS.register("sequence_reverse", infer_shape=_same)
OPS.get("sequence_reverse").impls["torch"] = lambda ctx, op, ins: {
    "Y": [torch.flip(ins["X"][0], dims=(1,))]}

_POOLS = {"MAX": lambda x: x.amax(dim=1), "AVERAGE": lambda x: x.mean(dim=1),
          "AVG": lambda x: x.mean(dim=1), "MEAN": lambda x: x.mean(dim=1),
          "SUM": lambda x: x.sum(dim=1), "LAST": lambda x: x[:, -1],
          "FIRST": lambda x: x[:, 0]}


@OPS.shape_fn("sequence_pool")
def sequence_pool_shape(attrs, in_shapes):
    b, _, d = in_shapes[0]
    return [(b, d)]


@OPS.kernel("sequence_pool", "torch")
def sequence_pool_torch(ctx, op, ins):
    ptype = op.attrs.get("pooltype", "MAX").upper()
    if ptype not in _POOLS:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": [_POOLS[ptype](ins["X"][0])]}


@OPS.shape_fn("sequence_expand")
def sequence_expand_shape(attrs, in_shapes):
    x, y = in_shapes
    return [(x[0], y[1], x[-1])]


@OPS.kernel("sequence_expand", "torch")
def sequence_expand_torch(ctx, op, ins):
    """Each row of X repeated along Y's time axis (a view)."""
    x, t = ins["X"][0], ins["Y"][0].shape[1]
    if x.ndim == 2:
        x = x[:, None, :]
    return {"Out": [x.expand(x.shape[0], t, x.shape[-1])]}


@OPS.shape_fn("sequence_concat")
def sequence_concat_shape(attrs, in_shapes):
    b, _, d = in_shapes[0]
    return [(b, sum(s[1] for s in in_shapes), d)]


@OPS.kernel("sequence_concat", "torch")
def sequence_concat_torch(ctx, op, ins):
    return {"Out": [torch.cat(ins["X"], dim=1)]}


# ---------------------------------------------------------------------------
# beam_search (``sequence.py:385-416`` there)
# ---------------------------------------------------------------------------

@OPS.shape_fn("beam_search")
def beam_search_shape(attrs, in_shapes):
    b, beam, _ = in_shapes[2]
    return [(b, beam), (b, beam), (b, beam)]


@OPS.kernel("beam_search", "torch")
def beam_search_torch(ctx, op, ins):
    """One step: each beam's log-probabilities (probabilities floored at
    1e-20) plus its score, a finished beam (its last id ``end_id``) only
    continued by ``end_id`` at its own score; the best ``beam`` of the
    beam × V candidates of each batch row, as token, score and parent."""
    pre_ids, pre_scores = ins["pre_ids"][0], ins["pre_scores"][0]
    probs = ins["scores"][0]  # (B, beam, V)
    end_id = int(op.attrs.get("end_id", 0))
    b, beam, v = probs.shape
    dev = probs.device
    logp = torch.log(torch.clamp_min(probs, f32(1e-20, dev)))
    only_end = ctx.const(op, "only_end", lambda: torch.where(
        torch.arange(v, device=dev) == end_id, f32(0.0, dev), f32(float("-inf"), dev)))
    cand = torch.where((pre_ids == end_id)[..., None], only_end, logp) + pre_scores[..., None]
    top_s, idx = topk_stable(cand.reshape(b, beam * v), beam)
    return {"selected_ids": [(idx % v).to(torch.int32)], "selected_scores": [top_s],
            "parent_idx": [torch.div(idx, v, rounding_mode="floor").to(torch.int32)]}
