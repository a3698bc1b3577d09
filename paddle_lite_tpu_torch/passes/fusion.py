"""Fusion passes — analog of ``lite/core/mir/fusion/``.

Copy of ``paddle_lite_tpu/passes/fusion.py`` (numpy only), whole, because
``tools/opt.optimize`` runs every pass of ``FUSION_PASSES``.  Implemented fusers (names match the reference's pass registry):

- ``conv_bn_fuse`` (conv_bn_fuse_pass.cc): folds batch_norm into the
  preceding conv's filter/bias.  Must run *before* PTQ weight quantization so
  the folded fp32 weights are what get per-channel scales (the reference's
  int8-weight refold case arises only for pre-quantized QAT imports, handled
  in ``quant_dequant_fuse``).
- ``conv_activation_fuse`` (conv_activation_fuse_pass.cc): relu / relu6 /
  leaky_relu / hard_swish / hard_sigmoid / sigmoid into conv's ``fuse_act``.
  On TPU this matters for the *int8* path: the activation must execute inside
  the requant epilogue before saturating to int8.
- ``conv_elementwise_fuse`` (conv_elementwise_fuse_pass.cc): an
  elementwise_add whose Y is a 1-D per-channel weight becomes the conv Bias;
  an elementwise_add with a second activation operand becomes ResidualData
  (the ResNet shortcut).
- ``fc_fuse`` (fc_fuse_pass.cc): mul + elementwise_add → fc.
- ``identity_elimination`` (mir/elimination/*): inference-mode dropout,
  identity scale, assign/io_copy no-ops.
"""

from __future__ import annotations

import numpy as np

from ..core.ir import Graph, OpNode
from ..core.pass_manager import register_pass
from ..core.pattern_matcher import match_chain, op_of

_CONV_TYPES = ("conv2d", "depthwise_conv2d", "conv2d_transpose")
_FUSABLE_ACTS = (
    "relu", "relu6", "leaky_relu", "hard_swish", "hard_sigmoid", "sigmoid",
    "swish", "relu_clipped", "gelu",
)


def _drop_op_rewire(graph: Graph, op: OpNode, keep_var: str, drop_var: str) -> None:
    """Remove `op`, making consumers of its output read `keep_var`."""
    graph.remove_ops([op])
    graph.replace_var_uses(drop_var, keep_var)


@register_pass("conv_bn_fuse")
def conv_bn_fuse(graph: Graph) -> None:
    for conv, bn in match_chain(
        graph, [op_of(_CONV_TYPES), op_of("batch_norm")]
    ):
        if conv.attrs.get("fuse_act"):
            continue  # act already fused => bn after act is not foldable
        scale = graph.weights[bn.input("Scale")]
        bias = graph.weights[bn.input("Bias")]
        mean = graph.weights[bn.input("Mean")]
        var = graph.weights[bn.input("Variance")]
        eps = bn.attrs.get("epsilon", 1e-5)
        inv = scale / np.sqrt(var + eps)  # per output channel

        w_name = conv.input("Filter")
        w = graph.weights[w_name]
        if w.dtype == np.int8:
            continue  # QAT int8 weights: refold handled at import time
        graph.weights[w_name] = (w * inv.reshape(1, 1, 1, -1)).astype(np.float32)

        new_bias = bias - mean * inv
        if conv.maybe_input("Bias"):
            b_name = conv.input("Bias")
            graph.weights[b_name] = (
                graph.weights[b_name] * inv + new_bias
            ).astype(np.float32)
        else:
            b_name = graph.unique_name(w_name + ".bnbias")
            graph.add_weight(b_name, new_bias.astype(np.float32))
            conv.inputs["Bias"] = [b_name]
        _drop_op_rewire(graph, bn, conv.output("Output"), bn.output("Y"))


@register_pass("conv_activation_fuse")
def conv_activation_fuse(graph: Graph) -> None:
    for conv, act in match_chain(
        graph, [op_of(_CONV_TYPES), op_of(_FUSABLE_ACTS)]
    ):
        if conv.attrs.get("fuse_act"):
            continue
        conv.attrs["fuse_act"] = act.op_type
        conv.attrs["act_attrs"] = dict(act.attrs)
        _drop_op_rewire(graph, act, conv.output("Output"), act.output("Out"))


@register_pass("conv_elementwise_fuse")
def conv_elementwise_fuse(graph: Graph) -> None:
    for conv, add in match_chain(
        graph, [op_of(_CONV_TYPES), op_of("elementwise_add")]
    ):
        if conv.attrs.get("fuse_act"):
            continue
        # conv output must be add's X (chain matcher guarantees an edge, but
        # the conv result may arrive on either slot)
        conv_out = conv.output("Output")
        other = add.input("Y") if add.input("X") == conv_out else add.input("X")
        other_var = graph.vars[other]
        oc = graph.vars[conv_out].shape[-1]
        if other_var.is_weight and other_var.shape in ((oc,), (1, oc)):
            if conv.maybe_input("Bias"):
                b_name = conv.input("Bias")
                graph.weights[b_name] = (
                    graph.weights[b_name] + graph.weights[other].reshape(-1)
                ).astype(np.float32)
            else:
                conv.inputs["Bias"] = [other]
        elif not other_var.is_weight and other_var.shape == graph.vars[conv_out].shape:
            if conv.maybe_input("ResidualData") or other_var.def_op is conv:
                continue
            conv.inputs["ResidualData"] = [other]
        else:
            continue
        _drop_op_rewire(graph, add, conv_out, add.output("Out"))


@register_pass("fc_fuse")
def fc_fuse(graph: Graph) -> None:
    for mul, add in match_chain(graph, [op_of("mul"), op_of("elementwise_add")]):
        mul_out = mul.output("Out")
        other = add.input("Y") if add.input("X") == mul_out else add.input("X")
        other_var = graph.vars[other]
        od = graph.vars[mul_out].shape[-1]
        if not (other_var.is_weight and other_var.shape in ((od,), (1, od))):
            continue
        mul.op_type = "fc"
        mul.inputs = {"Input": [mul.input("X")], "W": [mul.input("Y")],
                      "Bias": [other]}
        mul.attrs["in_num_col_dims"] = mul.attrs.pop("x_num_col_dims", 1)
        _drop_op_rewire(graph, add, mul_out, add.output("Out"))


@register_pass("identity_elimination")
def identity_elimination(graph: Graph) -> None:
    dead = []
    for op in list(graph.ops):
        is_id = False
        if op.op_type == "dropout" and op.attrs.get(
            "dropout_implementation", "downgrade_in_infer"
        ) == "upscale_in_train":
            is_id = True
        if op.op_type == "dropout" and op.attrs.get("dropout_prob", 0.0) == 0.0:
            is_id = True
        if op.op_type == "scale" and op.attrs.get("scale", 1.0) == 1.0 \
                and op.attrs.get("bias", 0.0) == 0.0:
            is_id = True
        if op.op_type in ("assign", "io_copy", "io_copy_once"):
            is_id = True
        if is_id:
            dead.append(op)
    for op in dead:
        # read names at removal time: earlier rewires may have updated them
        in_name, out_name = op.input_names()[0], op.output_names()[0]
        if out_name in graph.outputs and in_name in graph.inputs:
            continue  # degenerate: input directly wired to output
        _drop_op_rewire(graph, op, in_name, out_name)


@register_pass("parallel_fc_fuse")
def parallel_fc_fuse(graph: Graph) -> None:
    """Merge sibling fc ops that read the SAME input activation into one
    GEMM + split — the transformer QKV fusion.  No reference counterpart
    (the reference ran ops one-by-one on CPU where this doesn't pay); on the
    MXU one (M, K)x(K, 3O) matmul beats three (M, K)x(K, O) launches and
    reads the activation from HBM once instead of three times.  Runs after
    ``fc_fuse`` (so mul+add chains are already fc) and before calibration,
    which therefore observes the fused graph.
    """
    from collections import defaultdict

    groups = defaultdict(list)
    for op in graph.ops:
        if op.op_type != "fc" or op.attrs.get("fuse_act"):
            continue
        w_name = op.maybe_input("W")
        if w_name is None or not graph.vars[w_name].is_weight:
            continue
        w = graph.weights[w_name]
        if w.ndim != 2 or w.dtype != np.float32:
            continue
        x_name = op.input("Input")
        ncd = int(op.attrs.get("in_num_col_dims",
                               len(graph.vars[x_name].shape) - 1))
        groups[(x_name, ncd, w.shape[0])].append(op)

    for (x_name, ncd, k), ops in groups.items():
        if len(ops) < 2:
            continue
        sections = [int(graph.weights[o.input("W")].shape[1]) for o in ops]
        w_cat = np.concatenate(
            [graph.weights[o.input("W")] for o in ops], axis=1)
        biases = []
        for o, sec in zip(ops, sections):
            b = o.maybe_input("Bias")
            biases.append(graph.weights[b].reshape(-1) if b
                          else np.zeros((sec,), np.float32))
        w_name = graph.unique_name(ops[0].input("W") + ".pfc")
        graph.add_weight(w_name, w_cat.astype(np.float32))
        b_name = graph.unique_name(w_name + ".bias")
        graph.add_weight(b_name, np.concatenate(biases).astype(np.float32))
        lead = tuple(graph.vars[ops[0].output("Out")].shape[:-1])
        fused_out = graph.unique_name(x_name + ".pfc")
        graph.add_var(fused_out, lead + (sum(sections),))
        graph.add_op("fc", {"Input": [x_name], "W": [w_name],
                            "Bias": [b_name]},
                     {"Out": [fused_out]}, {"in_num_col_dims": ncd})
        # split writes straight into the original output names: consumers
        # (and their calibrated scales) are untouched
        graph.add_op("split", {"X": [fused_out]},
                     {"Out": [o.output("Out") for o in ops]},
                     {"axis": len(lead), "sections": sections})
        graph.remove_ops(ops)


@register_pass("fc_activation_fuse")
def fc_activation_fuse(graph: Graph) -> None:
    """fc + activation -> fc(fuse_act) — the fc counterpart of
    conv_activation_fuse. With the act inside the epilogue, an int8 fc can
    requantize straight to int8 (ffn1 -> gelu -> ffn2 chains stay int8
    end-to-end instead of detouring through an fp32 activation pass)."""
    for fc, act in match_chain(graph, [op_of(("fc",)), op_of(_FUSABLE_ACTS + ("tanh",))]):
        if fc.attrs.get("fuse_act"):
            continue
        fc.attrs["fuse_act"] = act.op_type
        fc.attrs["act_attrs"] = dict(act.attrs)
        _drop_op_rewire(graph, act, fc.output("Out"), act.output("Out"))


@register_pass("stem_space_to_depth")
def stem_space_to_depth(graph: Graph) -> None:
    """Rewrite the MXU-hostile stem conv (few input channels, stride 2) as
    space-to-depth + a dense stride-1 conv.

    A k×k/s2 conv over C_in≤4 channels has a contraction depth of only
    k·k·C_in (27 for a 3×3 RGB stem).  Space-to-depth with
    block 2 folds each 2×2 pixel block into channels: the conv becomes
    ⌈(k+1)/2⌉² × 4·C_in deep and stride 1 — 48-deep for 3×3 stems, 192 for
    ResNet's 7×7 — and the stride-2 subsampling becomes the s2d itself.
    No reference analog (the trick is TPU/systolic-specific); standard
    practice in public TPU CNN implementations.

    Exact rewrite (same math, reassociated): for output y,x and semantic
    tap dh∈[0,k): input row 2y+dh−p = 2(y+dh′)+bh with bh=(dh−p) mod 2,
    dh′=(dh−p−bh)/2, so tap (dh,dw,c) lands at new-kernel position
    (dh′−dh′_min, dw′−dw′_min) and channel (bh·2+bw)·C_in+c; the new conv
    pads (−dh′_min, dh′_max).
    """
    for conv in list(graph.ops):
        if conv.op_type != "conv2d":
            continue
        x_name = conv.input("Input")
        x_var = graph.vars[x_name]
        if x_var.def_op is not None or x_var.is_weight:
            continue  # only graph-input stems
        if len(x_var.shape) != 4:
            continue
        n, h, wdt, c_in = x_var.shape
        if c_in > 4 or h % 2 or wdt % 2:
            continue
        strides = conv.attrs.get("strides", [1, 1])
        if list(strides) != [2, 2]:
            continue
        if list(conv.attrs.get("dilations", [1, 1])) != [1, 1]:
            continue
        if int(conv.attrs.get("groups", 1)) != 1:
            continue
        w_name = conv.input("Filter")
        w = graph.weights[w_name]
        if w.dtype != np.float32:
            continue  # run before weight quantization
        kh, kw, _, oc = w.shape
        pads = conv.attrs.get("paddings", [0, 0])
        if len(pads) == 2:
            ph0 = ph1 = int(pads[0])
            pw0 = pw1 = int(pads[1])
        else:
            ph0, ph1, pw0, pw1 = (int(p) for p in pads)
        if ph0 != ph1 or pw0 != pw1:
            continue  # keep it simple: symmetric-padding stems only

        def tap(d, p):
            v = d - p
            b = v % 2
            return (v - b) // 2, b

        hps = [tap(d, ph0) for d in range(kh)]
        wps = [tap(d, pw0) for d in range(kw)]
        hmin, hmax = min(t[0] for t in hps), max(t[0] for t in hps)
        wmin, wmax = min(t[0] for t in wps), max(t[0] for t in wps)
        k2h, k2w = hmax - hmin + 1, wmax - wmin + 1
        # right pads sized so the output count matches the original exactly
        # (floor-division may drop a partial window; can go negative = crop)
        out_h = (h + 2 * ph0 - kh) // 2 + 1
        out_w = (wdt + 2 * pw0 - kw) // 2 + 1
        pad_h1 = out_h - 1 + hmax - (h // 2 - 1)
        pad_w1 = out_w - 1 + wmax - (wdt // 2 - 1)
        w2 = np.zeros((k2h, k2w, 4 * c_in, oc), np.float32)
        for dh in range(kh):
            dhp, bh = hps[dh]
            for dw in range(kw):
                dwp, bw = wps[dw]
                ch = (bh * 2 + bw) * c_in
                w2[dhp - hmin, dwp - wmin, ch:ch + c_in, :] = w[dh, dw, :, :]

        s2d_out = graph.unique_name(x_name + ".s2d")
        graph.add_var(s2d_out, (n, h // 2, wdt // 2, 4 * c_in))
        graph.add_op("space_to_depth", {"X": [x_name]}, {"Out": [s2d_out]},
                     {"blocks": [2, 2]})
        graph.weights[w_name] = w2
        graph.vars[w_name].shape = w2.shape
        conv.inputs["Input"] = [s2d_out]
        conv.attrs["strides"] = [1, 1]
        conv.attrs["paddings"] = [-hmin, pad_h1, -wmin, pad_w1]
        graph.rebuild_links()


@register_pass("deconv_pack")
def deconv_pack(graph: Graph) -> None:
    """Spatial-in-lanes packing of lane-starved deconv heads (the DBNet
    prob-map head: 2x2s2 deconv chains down to 1 channel at 640px).

    A non-overlapping deconv (kernel == stride == 2) is exactly a 1x1 conv
    emitting the 2x2 output block into channels, followed by depth-to-space
    (the conv2d_transpose kernel already exploits this per-op).  What that
    per-op form still pays is every DOWNSTREAM op running at the upsampled
    resolution with 24→1 channels: on TPU the minor (lane) axis tiles to
    128, so a (640, 640, 1) fp32 map costs up to 128x its true bytes per
    elementwise pass.  This pass keeps the data PACKED — spatial positions
    ride the lane axis — and sinks the unpack to the chain end:

      deconv(2x2s2) [-> bn] [-> act] [-> deconv(2x2s2)] [-> act] ...
        ==>  conv1x1(packed W) -> bn(tiled params) -> act
             -> conv1x1(block W) -> act -> ONE pixel_shuffle(B)

    Packed channel order is (dy, dx, c) — pixel_shuffle's contract — so a
    second deconv composes to block B=4 with W'[(d1,c),(2*d1+d2,o)] =
    w2[d2,c,o] and 1x1 convs sink as kron(I_{B^2}, W).  Exact rewrite
    (same math, reassociated); applied only where the packed lane count
    stays <= 128 (i.e. the head was lane-starved to begin with).

    Reference analog: none (TPU tiling-specific); the reference's ARM
    kernels iterate NCHW rows where a 1-channel 640px map is cheap.
    """
    graph.rebuild_links()
    _SINK_ACTS = _FUSABLE_ACTS + ("sigmoid", "tanh")

    def eligible_deconv(op):
        w = graph.weights.get(op.input("Filter"))
        if w is None or w.dtype != np.float32:
            return None
        if w.shape[0] != 2 or w.shape[1] != 2:
            return None
        a = op.attrs
        if [int(s) for s in a.get("strides", [1, 1])] != [2, 2]:
            return None
        if any(int(p) for p in a.get("paddings", [0, 0])):
            return None
        if [int(d) for d in a.get("dilations", [1, 1])] != [1, 1]:
            return None
        if int(a.get("groups", 1)) != 1:
            return None
        if any(int(p) for p in a.get("output_padding", [0, 0])):
            return None
        return w

    def single_consumer(var_name):
        if var_name in graph.outputs:
            return None
        cons = [o for o in graph.ops
                if var_name in o.input_names()]
        return cons[0] if len(cons) == 1 else None

    for op in list(graph.ops):
        if op.op_type != "conv2d_transpose" or op not in graph.ops:
            continue
        w = eligible_deconv(op)
        if w is None or 4 * w.shape[3] > 128:
            continue

        # T1 -> packed 1x1 conv (in place)
        ci, oc = w.shape[2], w.shape[3]
        w_name = op.input("Filter")
        graph.weights[w_name] = np.ascontiguousarray(
            w.transpose(2, 0, 1, 3).reshape(1, 1, ci, 4 * oc))
        graph.vars[w_name].shape = (1, 1, ci, 4 * oc)
        b_slot = op.maybe_input("Bias")
        if b_slot:
            bname = graph.unique_name(b_slot + ".pk")
            graph.add_weight(bname, np.tile(graph.weights[b_slot], 4))
            op.inputs["Bias"] = [bname]
        op.op_type = "conv2d"
        op.attrs = {"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1], "groups": 1}
        B = 2
        cur = op.output("Output")
        n, h2, w2_, _ = graph.vars[cur].shape
        graph.vars[cur].shape = (n, h2 // 2, w2_ // 2, 4 * oc)
        cur_orig_shape = (n, h2, w2_, oc)
        chan = oc  # true (unpacked) channel count of cur
        last = op

        # sink the unpack down the single-consumer chain
        while True:
            nxt = single_consumer(cur)
            if nxt is None:
                break
            if nxt.op_type == "batch_norm":
                for slot in ("Scale", "Bias", "Mean", "Variance"):
                    pn = nxt.input(slot)
                    tn = graph.unique_name(pn + ".pk")
                    graph.add_weight(
                        tn, np.tile(np.asarray(graph.weights[pn]), B * B))
                    nxt.inputs[slot] = [tn]
            elif nxt.op_type in _SINK_ACTS and list(nxt.inputs) == ["X"]:
                pass
            elif nxt.op_type == "conv2d_transpose":
                w2 = eligible_deconv(nxt)
                if w2 is None or w2.shape[2] != chan \
                        or (2 * B) ** 2 * w2.shape[3] > 128:
                    break
                oc2 = w2.shape[3]
                wn = np.zeros((B * B * chan, (2 * B) ** 2 * oc2), np.float32)
                for d1y in range(B):
                    for d1x in range(B):
                        for d2y in range(2):
                            for d2x in range(2):
                                i0 = (d1y * B + d1x) * chan
                                o0 = ((d1y * 2 + d2y) * 2 * B
                                      + (d1x * 2 + d2x)) * oc2
                                wn[i0:i0 + chan, o0:o0 + oc2] = w2[d2y, d2x]
                wname = nxt.input("Filter")
                graph.weights[wname] = wn.reshape(
                    1, 1, B * B * chan, (2 * B) ** 2 * oc2)
                graph.vars[wname].shape = graph.weights[wname].shape
                bs = nxt.maybe_input("Bias")
                if bs:
                    bn2 = graph.unique_name(bs + ".pk")
                    graph.add_weight(
                        bn2, np.tile(graph.weights[bs], (2 * B) ** 2))
                    nxt.inputs["Bias"] = [bn2]
                nxt.op_type = "conv2d"
                nxt.attrs = {"strides": [1, 1], "paddings": [0, 0],
                             "dilations": [1, 1], "groups": 1}
                B *= 2
                chan = oc2
            elif (nxt.op_type == "conv2d"
                  and graph.weights.get(nxt.input("Filter")) is not None
                  and graph.vars[nxt.input("Filter")].shape[:2] == (1, 1)
                  and [int(s) for s in nxt.attrs.get("strides", [1, 1])]
                  == [1, 1]
                  and not any(int(p)
                              for p in nxt.attrs.get("paddings", [0, 0]))
                  and int(nxt.attrs.get("groups", 1)) == 1
                  and not nxt.maybe_input("ResidualData")
                  and graph.weights[nxt.input("Filter")].dtype == np.float32
                  and B * B * graph.vars[nxt.input("Filter")].shape[3] <= 128):
                wname = nxt.input("Filter")
                wv = graph.weights[wname][0, 0]  # (ci, oc2)
                oc2 = wv.shape[1]
                graph.weights[wname] = np.ascontiguousarray(
                    np.kron(np.eye(B * B, dtype=np.float32), wv)
                    .reshape(1, 1, B * B * chan, B * B * oc2))
                graph.vars[wname].shape = graph.weights[wname].shape
                bs = nxt.maybe_input("Bias")
                if bs:
                    bn2 = graph.unique_name(bs + ".pk")
                    graph.add_weight(bn2, np.tile(graph.weights[bs], B * B))
                    nxt.inputs["Bias"] = [bn2]
                chan = oc2
            else:
                break
            # nxt now produces packed data: shrink its output var
            out_n = nxt.output_names()[0]
            on, oh, ow, _ = graph.vars[out_n].shape
            cur_orig_shape = (on, oh, ow, chan)
            graph.vars[out_n].shape = (on, oh // B, ow // B, B * B * chan)
            cur = out_n
            last = nxt

        # unpack once at the chain end: last op writes a fresh packed var,
        # pixel_shuffle restores the original name/shape for consumers
        packed = graph.unique_name(cur + ".packed")
        graph.add_var(packed, graph.vars[cur].shape)
        for slot, names in last.outputs.items():
            last.outputs[slot] = [packed if nm == cur else nm
                                  for nm in names]
        graph.vars[cur].shape = cur_orig_shape
        graph.add_op("pixel_shuffle", {"X": [packed]}, {"Out": [cur]},
                     {"upscale_factor": B})
        graph.rebuild_links()
