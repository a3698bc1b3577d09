"""Pretrained-weight importer — the model-ingestion half of the reference's
``lite/model_parser`` (which loaded fluid protobuf programs + weights).

Copy of ``paddle_lite_tpu/formats/importer.py`` (numpy only).

No fluid/protobuf dependency exists in this environment, so the import
surface is (a) PyTorch ``state_dict``s (torch-cpu is available; covers
torchvision-style checkpoints) and (b) plain name→ndarray dicts (e.g.
safetensors loaded externally).  The importer walks the target graph in
topological order and consumes source parameters *in order*, matched by
role and shape — robust to naming differences as long as the architectures
correspond layer-for-layer (the same contract a fluid importer would have).

Layout conversions (reference NCHW / torch OIHW → our NHWC / HWIO):
- conv weight  OIHW → HWIO            (transpose 2,3,1,0)
- depthwise    O1HW → HW1O            (torch groups=C convention)
- fc weight    (out, in) → (in, out)  (transpose)
- vectors (bias, bn stats) unchanged
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.ir import Graph, OpNode


class ImportError_(RuntimeError):
    pass


def _to_numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):  # torch tensor without importing torch
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def convert_conv_weight(w: np.ndarray, depthwise: bool = False) -> np.ndarray:
    """OIHW -> HWIO (depthwise torch O1HW -> HW1O)."""
    return np.transpose(w, (2, 3, 1, 0))


def convert_fc_weight(w: np.ndarray) -> np.ndarray:
    """(out, in) -> (in, out)."""
    return np.transpose(w, (1, 0))


def nchw_input_to_nhwc(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (0, 2, 3, 1))


def _flattened_spatial_shape(graph: Graph, op: OpNode):
    """If this fc/mul consumes a reshape/flatten of a 4-D NHWC tensor with
    REAL spatial extent (H*W > 1), return (H, W, C) — its torch-side weight
    was laid out over flattened NCHW and needs row reordering."""
    x_name = op.maybe_input("Input") or op.maybe_input("X")
    if x_name is None:
        return None
    producer = graph.vars[x_name].def_op
    if producer is None or producer.op_type not in (
        "reshape", "reshape2", "flatten", "flatten2", "squeeze", "squeeze2"
    ):
        return None
    src = graph.vars[producer.input_names()[0]]
    if len(src.shape) != 4:
        return None
    _, h, w, c = src.shape
    if h * w == 1:
        return None  # post-global-pool: ordering is irrelevant
    return (h, w, c)


class _ParamStream:
    """Ordered source parameters with role-aware lookahead."""

    def __init__(self, params: Dict[str, np.ndarray]):
        self.items: List[Tuple[str, np.ndarray]] = [
            (k, _to_numpy(v)) for k, v in params.items()
            if not k.endswith("num_batches_tracked")
        ]
        self.pos = 0

    def take(self, want_shape: Tuple[int, ...], what: str,
             transform=None) -> np.ndarray:
        if self.pos >= len(self.items):
            raise ImportError_(f"ran out of source params wanting {what} "
                               f"{want_shape}")
        key, val = self.items[self.pos]
        out = transform(val) if transform else val
        if tuple(out.shape) != tuple(want_shape):
            raise ImportError_(
                f"param {key!r}: expected {what} of shape {want_shape}, "
                f"got {tuple(out.shape)} (raw {tuple(val.shape)})"
            )
        self.pos += 1
        return np.ascontiguousarray(out, np.float32)

    def done(self) -> bool:
        return self.pos >= len(self.items)


def import_state_dict(graph: Graph, params: Dict[str, np.ndarray],
                      *, strict: bool = True) -> int:
    """Fill `graph.weights` from an ordered param dict (torch state_dict or
    name→ndarray).  Returns the number of parameters consumed.

    Must run on the UNOPTIMIZED graph (before conv_bn_fuse), whose op order
    mirrors the source model's module order.
    """
    stream = _ParamStream(params)
    n0 = stream.pos
    # creation order, NOT topological_order(): Kahn reshuffles parallel
    # branches (e.g. a ResNet projection conv and main-path conv1 both
    # become ready before their bns), while the builder/imported op list
    # mirrors the source module registration order the param stream uses
    for op in graph.ops:
        t = op.op_type
        if t in ("conv2d", "depthwise_conv2d", "conv2d_transpose"):
            w_name = op.input("Filter")
            want = graph.vars[w_name].shape
            graph.weights[w_name] = stream.take(
                want, f"{t} filter",
                lambda v: convert_conv_weight(v, t == "depthwise_conv2d"))
            if op.maybe_input("Bias"):
                b_name = op.input("Bias")
                graph.weights[b_name] = stream.take(
                    graph.vars[b_name].shape, "conv bias")
        elif t == "batch_norm":
            # torch order: weight(gamma), bias(beta), running_mean, running_var
            for slot, what in (("Scale", "bn gamma"), ("Bias", "bn beta"),
                               ("Mean", "bn mean"), ("Variance", "bn var")):
                name = op.input(slot)
                graph.weights[name] = stream.take(
                    graph.vars[name].shape, what)
        elif t in ("fc", "mul"):
            w_name = op.input("W" if t == "fc" else "Y")
            if not graph.vars[w_name].is_weight:
                continue
            want = graph.vars[w_name].shape
            spatial = _flattened_spatial_shape(graph, op)
            if spatial is not None:
                h, w_, c = spatial

                def conv_fc(v, h=h, w_=w_, c=c):
                    # torch flattened NCHW (out, C*H*W); our input flattened
                    # NHWC -> reorder rows to H*W*C before transposing
                    out_dim = v.shape[0]
                    return (v.reshape(out_dim, c, h, w_)
                            .transpose(2, 3, 1, 0)
                            .reshape(h * w_ * c, out_dim))

                graph.weights[w_name] = stream.take(
                    want, f"{t} weight (spatial-flatten reorder)", conv_fc)
            else:
                graph.weights[w_name] = stream.take(want, f"{t} weight",
                                                    convert_fc_weight)
            if t == "fc" and op.maybe_input("Bias"):
                b_name = op.input("Bias")
                graph.weights[b_name] = stream.take(
                    graph.vars[b_name].shape, "fc bias")
        elif t in ("lookup_table", "lookup_table_v2"):
            w_name = op.input("W")
            graph.weights[w_name] = stream.take(
                graph.vars[w_name].shape, "embedding")
        elif t == "layer_norm":
            for slot, what in (("Scale", "ln gamma"), ("Bias", "ln beta")):
                if op.maybe_input(slot):
                    name = op.input(slot)
                    graph.weights[name] = stream.take(
                        graph.vars[name].shape, what)
    consumed = stream.pos - n0
    if strict and not stream.done():
        leftover = [k for k, _ in stream.items[stream.pos:]][:5]
        raise ImportError_(
            f"{len(stream.items) - stream.pos} source params unconsumed, "
            f"e.g. {leftover}")
    return consumed
