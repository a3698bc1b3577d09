"""PP-OCRv2 det + rec — BASELINE config #4 (mixed int8 / fp graphs).

Port of ``paddle_lite_tpu/models/ppocr.py`` (``build_det`` ``:54-98``,
``build_rec`` ``:130-162``): the same graphs, op for op, and the same
seeded weights, drawn in the same order from the builder's generator.

- **Detection (DBNet)**: a MobileNetV3-style trunk tapped at /4, /8, /16
  and /32 → an FPN neck (1x1 laterals, nearest upsample adds, 3x3 smooth)
  → the DB head (conv-bn-relu, two 2x2/s2 transposed convs, sigmoid): the
  probability map.  ``deconv_pack`` (``passes/fusion.py``) rewrites the
  head's transposed convs as 1x1 convs and ``pixel_shuffle``.
- **Recognition (CRNN)**: a conv trunk with height-only (2, 1) pooling →
  the height squeezed into a sequence → two bidirectional GRUs (int8
  ``mul`` input projections, ``bidirectional_gru`` recurrences) → the
  per-step CTC classifier → softmax → ``ctc_greedy_decode``.
"""

from __future__ import annotations

import numpy as np

from ..core.builder import GraphBuilder
from ..core.ir import Graph


# ---------------------------------------------------------------------------
# DBNet detector
# ---------------------------------------------------------------------------

def _backbone_taps(b: GraphBuilder, x: str):
    """4-scale MobileNetV3-ish trunk; returns taps at /4, /8, /16, /32."""
    taps = []
    x = b.conv_bn_act(x, 16, 3, stride=2, padding=1, act="hard_swish")
    x = b.conv_bn_act(x, 16, 3, stride=2, padding=1, depthwise=True, act="relu")
    x = b.conv_bn_act(x, 24, 1, act="relu")
    taps.append(x)  # /4
    for out_c, n in [(56, 2), (104, 3), (160, 2)]:
        x = b.conv_bn_act(x, b.g.vars[x].shape[-1], 3, stride=2, padding=1,
                          depthwise=True, act="hard_swish")
        x = b.conv_bn_act(x, out_c, 1, act="hard_swish")
        for _ in range(n - 1):
            x = b.conv_bn_act(x, out_c, 3, padding=1, depthwise=True,
                              act="hard_swish")
            x = b.conv_bn_act(x, out_c, 1, act="hard_swish")
        taps.append(x)
    return taps


def _upsample(b: GraphBuilder, x: str, factor: int = 2) -> str:
    n, h, w, c = b.g.vars[x].shape
    return b.op("nearest_interp", {"X": [x]},
                attrs={"out_h": h * factor, "out_w": w * factor},
                shape_args=[x])[0]


def build_det(batch: int = 1, image_size: int = 640, neck_ch: int = 96,
              seed: int = 0) -> Graph:
    b = GraphBuilder("ppocr_det_db", seed=seed)
    image = b.input("image", (batch, image_size, image_size, 3))
    c2, c3, c4, c5 = _backbone_taps(b, image)

    # FPN: lateral 1x1 to neck_ch, top-down upsample+add, 3x3 smooth to /4
    p5 = b.conv2d(c5, neck_ch, 1, bias=True)
    p4 = b.eltwise(b.conv2d(c4, neck_ch, 1, bias=True), _upsample(b, p5), "add")
    p3 = b.eltwise(b.conv2d(c3, neck_ch, 1, bias=True), _upsample(b, p4), "add")
    p2 = b.eltwise(b.conv2d(c2, neck_ch, 1, bias=True), _upsample(b, p3), "add")
    outs = []
    for p, up in [(p5, 8), (p4, 4), (p3, 2), (p2, 1)]:
        s = b.conv2d(p, neck_ch // 4, 3, padding=1, bias=True)
        if up > 1:
            s = _upsample(b, s, up)
        outs.append(s)
    fuse = b.concat(outs, axis=-1)  # (N, H/4, W/4, neck_ch)

    # DB head: conv-bn-relu → deconv x2 → deconv x2 → sigmoid
    y = b.conv_bn_act(fuse, neck_ch // 4, 3, padding=1, act="relu")
    w1 = b.rand_weight("db.up1.w", (2, 2, neck_ch // 4, neck_ch // 4))
    y = b.op("conv2d_transpose", {"Input": [y], "Filter": [w1]},
             attrs={"strides": [2, 2]}, shape_args=[y, w1],
             out_slots=("Output",))[0]
    y = b.batch_norm(y)
    y = b.act(y, "relu")
    w2 = b.rand_weight("db.up2.w", (2, 2, neck_ch // 4, 1))
    y = b.op("conv2d_transpose", {"Input": [y], "Filter": [w2]},
             attrs={"strides": [2, 2]}, shape_args=[y, w2],
             out_slots=("Output",))[0]
    prob = b.act(y, "sigmoid")  # (N, H, W, 1) text probability map
    b.mark_output(prob)
    return b.build()


# ---------------------------------------------------------------------------
# CRNN recognizer
# ---------------------------------------------------------------------------

def _bigru(b: GraphBuilder, x: str, hidden: int, name: str) -> str:
    """Bidirectional GRU: int8-quantizable input-projection muls + ONE
    direction-vmapped scan (bidirectional_gru op — both directions advance
    per step, half the sequential depth of two chained gru ops)."""
    d = b.g.vars[x].shape[-1]
    projs, whs, biases = [], [], []
    for direction in ("fw", "bw"):
        w_ih = b.rand_weight(f"{name}.{direction}.w_ih", (d, 3 * hidden),
                             scale=np.sqrt(1.0 / d))
        projs.append(b.op("mul", {"X": [x], "Y": [w_ih]},
                          attrs={"x_num_col_dims": 2, "y_num_col_dims": 1},
                          shape_args=[x, w_ih],
                          out_name=f"{name}.{direction}.proj")[0])
        whs.append(b.rand_weight(f"{name}.{direction}.w_hh",
                                 (hidden, 3 * hidden),
                                 scale=np.sqrt(1.0 / hidden)))
        biases.append(b.weight(f"{name}.{direction}.b",
                               np.zeros((3 * hidden,), np.float32)))
    return b.op(
        "bidirectional_gru",
        {"Input": [projs[0]], "InputRev": [projs[1]],
         "WeightFw": [whs[0]], "WeightBw": [whs[1]],
         "BiasFw": [biases[0]], "BiasBw": [biases[1]]},
        shape_args=[projs[0]], out_slots=("Hidden",), out_name=name,
    )[0]


def build_rec(batch: int = 1, height: int = 32, width: int = 320,
              hidden: int = 48, num_chars: int = 6625, seed: int = 0) -> Graph:
    b = GraphBuilder("ppocr_rec_crnn", seed=seed)
    image = b.input("image", (batch, height, width, 3))
    x = b.conv_bn_act(image, 32, 3, stride=2, padding=1, act="relu")
    x = b.conv_bn_act(x, 64, 3, padding=1, depthwise=True, act="relu")
    x = b.conv_bn_act(x, 64, 1, act="relu")
    x = b.pool2d(x, "max", ksize=2, stride=2)  # /4
    x = b.conv_bn_act(x, 128, 3, padding=1, depthwise=True, act="relu")
    x = b.conv_bn_act(x, 128, 1, act="relu")
    # height-only pooling keeps the time (width) resolution — CRNN signature
    x = b.pool2d(x, "max", ksize=(2, 1), stride=(2, 1))  # h/8, w/4
    x = b.conv_bn_act(x, 256, 3, padding=1, depthwise=True, act="relu")
    x = b.conv_bn_act(x, 256, 1, act="relu")
    x = b.pool2d(x, "max", ksize=(4, 1), stride=(4, 1))  # h -> 1
    n, h, w, c = b.g.vars[x].shape
    assert h == 1, h
    seq = b.reshape(x, (n, w, c))  # (B, T, C)

    seq = _bigru(b, seq, hidden, "rnn1")
    seq = _bigru(b, seq, hidden, "rnn2")

    d = b.g.vars[seq].shape[-1]
    w_cls = b.rand_weight("ctc_fc.w", (d, num_chars + 1),
                          scale=np.sqrt(1.0 / d))
    # trained CTC heads carry a bias (blank-dominant class priors live
    # there); zero-initialized so outputs are unchanged for fixed seeds
    b_cls = b.weight("ctc_fc.b", np.zeros((num_chars + 1,), np.float32))
    mm = b.op("mul", {"X": [seq], "Y": [w_cls]},
              attrs={"x_num_col_dims": 2, "y_num_col_dims": 1},
              shape_args=[seq, w_cls], out_name="ctc_mm")[0]
    logits = b.op("elementwise_add", {"X": [mm], "Y": [b_cls]},
                  attrs={"axis": -1}, shape_args=[mm, b_cls],
                  out_name="ctc_logits")[0]
    probs = b.softmax(logits, axis=-1)
    decoded, lengths = b.op(
        "ctc_greedy_decode", {"X": [probs]},
        shape_args=[probs], out_slots=("Out", "Length"),
    )
    b.mark_output(probs)
    b.mark_output(decoded)
    return b.build()
