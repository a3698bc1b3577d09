"""`fused_dw_pw` op — a depthwise (3x3, s1) + pointwise (1x1) int8 block
run as one kernel launch — and the graph pass that forms it.

Port of ``paddle_lite_tpu/ops/fused.py``.  The pass runs after quantization
(it needs the int8 marks, the dw requant scale that becomes the block's
internal precision boundary, and both weight scales) and before the
precision-cast and kernel-pick passes.  Conditions: the dw conv is int8
3x3/s1/SAME with a fused requant (``out_scale``), its output feeds only the
1x1/s1/group-1 int8 conv, neither has a residual operand, and C ≤ 128.

Two impls:

- ``"torch"`` (``fused_dw_pw_xla`` there): the composed form — dw conv,
  ``quantize`` (a division by the dw scale), 1x1 conv.
- ``"cuda"`` (``fused_dw_pw_pallas`` there): the fused kernel
  (``ops/kernels/dw_pw_fused.py``), which multiplies by the reciprocal as
  the unfused kernels do.  The reference's impl runs the XLA form when the
  input is not int8 (``fused.py:76-77``); here that raises.
"""

from __future__ import annotations

import torch

from ..core.ir import Graph
from ..core.pass_manager import register_pass
from ..core.pattern_matcher import match_chain, op_of
from ..core.registry import OPS
from .common import effective_conv_scale, requant_epilogue, upcast
from .kernels import depthwise
from .kernels import custom_ops
from .kernels.int8_matmul import ACTS
from .nn import conv_nhwc


@OPS.shape_fn("fused_dw_pw")
def fused_dw_pw_shape(attrs, in_shapes):
    n, h, w, _ = in_shapes[0]
    oc = in_shapes[1][3]  # PwFilter (1,1,C,O)
    return [(n, h, w, oc)]


def block_scales(ctx, op):
    """(s_x·s_dw, s_dwout·s_pw) as device tensors, folded once per op."""
    def make():
        xq = ctx.var_quant(op.input("Input"))
        dwq = ctx.var_quant(op.input("DwFilter"))
        pwq = ctx.var_quant(op.input("PwFilter"))
        return (ctx.tensor(effective_conv_scale(xq.scale[0], dwq.scale_array())),
                ctx.tensor(effective_conv_scale(op.attrs["dw_out_scale"],
                                                pwq.scale_array())))
    return ctx.const(op, "eff", make)


@OPS.kernel("fused_dw_pw", "torch")
def fused_dw_pw_torch(ctx, op, ins):
    """The composed form: dw conv + requant by division + pw conv."""
    x = ins["Input"][0]
    dw_w, pw_w = ins["DwFilter"][0], ins["PwFilter"][0]
    attrs = op.attrs
    n, h, w, c = x.shape
    dw_eff, pw_eff = block_scales(ctx, op)
    # exact int32 sums as fp32: <= 9 int8 products (dw), float64 (pw)
    acc = torch.round(conv_nhwc(
        x.to(torch.float32), dw_w.to(torch.float32).permute(3, 2, 0, 1),
        (1, 1), ((1, 1), (1, 1)), (1, 1), c))
    dw_q = requant_epilogue(acc, effective_scale=dw_eff,
                            bias=ins.get("DwBias", [None])[0],
                            act=attrs.get("dw_act"),
                            act_attrs=attrs.get("dw_act_attrs"),
                            out_scale=attrs["dw_out_scale"])
    pw2 = pw_w.reshape(c, -1)
    acc2 = (dw_q.reshape(-1, c).to(torch.float64)
            @ pw2.to(torch.float64)).to(torch.float32)
    z = requant_epilogue(acc2, effective_scale=pw_eff,
                         bias=ins.get("PwBias", [None])[0],
                         act=attrs.get("pw_act"),
                         act_attrs=attrs.get("pw_act_attrs"),
                         out_scale=attrs.get("out_scale"))
    return {"Output": [z.reshape(n, h, w, pw2.shape[1])]}


@OPS.kernel("fused_dw_pw", "cuda")
def fused_dw_pw_cuda(ctx, op, ins):
    x, dw_w, pw_w = ins["Input"][0], ins["DwFilter"][0], ins["PwFilter"][0]
    if x.dtype != torch.int8 or dw_w.dtype != torch.int8 or pw_w.dtype != torch.int8:
        raise ValueError(f"fused_dw_pw (kernel='cuda'): needs int8 operands, "
                         f"got {[x.dtype, dw_w.dtype, pw_w.dtype]}")
    attrs = op.attrs
    dw_eff, pw_eff = block_scales(ctx, op)
    pw_nk = None
    if x.device.type != "cpu":  # (O, C) once; the CPU path needs none
        pw_nk = ctx.const(op, "w_nk",
                          lambda: pw_w.reshape(x.shape[-1], -1).t().contiguous())
    dw_b, pw_b = (ins.get(s, [None])[0] for s in ("DwBias", "PwBias"))
    y = custom_ops.fused(  # a bf16-staged bias upcast, values kept
        x, dw_w, dw_eff, None if dw_b is None else upcast(dw_b), attrs["dw_out_scale"],
        pw_w, pw_eff, None if pw_b is None else upcast(pw_b),
        dw_act=attrs.get("dw_act"), dw_act_attrs=attrs.get("dw_act_attrs"),
        pw_act=attrs.get("pw_act"), pw_act_attrs=attrs.get("pw_act_attrs"),
        pw_out_scale=attrs.get("out_scale"), pw_w_nk=pw_nk)
    return {"Output": [y]}


# Fuse only blocks with at most this many channels (``fused.py:105`` there:
# the TPU measured a win for lane-starved blocks only).  Kept as the
# reference's gate so both packages form the same ops.
_FUSE_MAX_C = 128


@register_pass("dw_pw_fuse")
def dw_pw_fuse(graph: Graph) -> None:
    """Form ``fused_dw_pw`` ops; tag ``"cuda"`` when the CUDA epilogue
    computes both activations, else ``"torch"``."""
    for dw, pw in match_chain(
        graph, [op_of("depthwise_conv2d"), op_of("conv2d")]
    ):
        if not (dw.attrs.get("enable_int8") and pw.attrs.get("enable_int8")):
            continue
        if dw.attrs.get("out_scale") is None:
            continue  # dw output must be int8 (the internal boundary)
        x_name = dw.input("Input")
        if graph.vars[x_name].shape[3] > _FUSE_MAX_C:
            continue
        if not depthwise.supported(dw.attrs, graph.vars[x_name].shape,
                                   graph.vars[dw.input("Filter")].shape):
            continue
        pw_w = graph.vars[pw.input("Filter")]
        if pw_w.shape[0] != 1 or pw_w.shape[1] != 1:
            continue
        if tuple(pw.attrs.get("strides", (1, 1))) != (1, 1):
            continue
        if int(pw.attrs.get("groups", 1)) != 1:
            continue
        if dw.maybe_input("ResidualData") or pw.maybe_input("ResidualData"):
            continue

        inputs = {"Input": [x_name],
                  "DwFilter": [dw.input("Filter")],
                  "PwFilter": [pw.input("Filter")]}
        if dw.maybe_input("Bias"):
            inputs["DwBias"] = [dw.input("Bias")]
        if pw.maybe_input("Bias"):
            inputs["PwBias"] = [pw.input("Bias")]
        kernel = ("cuda" if dw.attrs.get("fuse_act") in ACTS
                  and pw.attrs.get("fuse_act") in ACTS else "torch")
        attrs = {
            "enable_int8": True,
            "kernel": kernel,
            "dw_act": dw.attrs.get("fuse_act"),
            "dw_act_attrs": dw.attrs.get("act_attrs"),
            "dw_out_scale": dw.attrs["out_scale"],
            "pw_act": pw.attrs.get("fuse_act"),
            "pw_act_attrs": pw.attrs.get("act_attrs"),
        }
        if pw.attrs.get("out_scale") is not None:
            attrs["out_scale"] = pw.attrs["out_scale"]
        out_name = pw.output("Output")
        graph.remove_ops([dw, pw])
        graph.add_op("fused_dw_pw", inputs, {"Output": [out_name]}, attrs)
    graph.rebuild_links()
    graph.remove_unused_vars()
