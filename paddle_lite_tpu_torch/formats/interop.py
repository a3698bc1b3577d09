"""Graphs carried across from the JAX package.

Port of the graph ↔ JSON half of ``paddle_lite_tpu/formats/artifact.py``
(``:28-140``: ``_quant_from_json``, ``_attrs_from_json``,
``graph_from_meta``); the native ``nbf`` container is not ported.

:func:`graph_from_reference` takes what the reference's
``artifact.graph_to_meta(graph)`` returns (plain JSON types) plus the graph's
weights as numpy arrays, and gives the identical graph here — ops, attrs,
scales and int8 weights — with the reference's kernel tags translated:
``"xla"`` → ``"torch"`` and ``"pallas"`` → ``"cuda"``.  That is how a test
optimizes with the JAX package and runs the same optimized graph through the
port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.ir import Graph, VarNode
from ..core.types import DataLayout, Precision, QuantInfo, TensorType

FORMAT_VERSION = 1

REFERENCE_KERNELS = {"xla": "torch", "pallas": "cuda"}


def _quant_from_json(j):
    if j is None:
        return None
    return QuantInfo(scale=tuple(j["scale"]), axis=j["axis"], bits=j["bits"],
                     pack_axis=j.get("pack_axis"))


def _attrs_from_json(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=np.dtype(v["dtype"]))
        elif isinstance(v, dict) and "__graph__" in v:
            g = graph_from_meta(v["__graph__"])
            g.weights = {
                n: np.asarray(w["__ndarray__"], dtype=np.dtype(w["dtype"]))
                for n, w in v["weights"].items()
            }
            g.rebuild_links()
            out[k] = g
        else:
            out[k] = v
    return out


def graph_from_meta(meta: dict) -> Graph:
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"artifact format version {meta.get('format_version')} "
            f"not supported (expected {FORMAT_VERSION})"
        )
    g = Graph(meta["name"])
    for name, vj in meta["vars"].items():
        g.vars[name] = VarNode(
            name=name,
            shape=tuple(vj["shape"]),
            ttype=TensorType(Precision(vj["precision"]), DataLayout(vj["layout"])),
            is_weight=vj["is_weight"],
            quant=_quant_from_json(vj["quant"]),
        )
    for oj in meta["ops"]:
        g.add_op(oj["type"], oj["inputs"], oj["outputs"], _attrs_from_json(oj["attrs"]))
    g.inputs = list(meta["inputs"])
    g.outputs = list(meta["outputs"])
    g.meta = dict(meta.get("meta", {}))
    return g


def graph_from_reference(meta: dict, weights: Dict[str, np.ndarray]) -> Graph:
    """The reference's ``graph_to_meta(graph)`` + ``graph.weights`` → Graph."""
    g = graph_from_meta(meta)
    g.weights = {k: np.array(v, copy=True) for k, v in weights.items()}
    for op in g.ops:
        tag = op.attrs.get("kernel")
        if tag is None:
            continue
        if tag not in REFERENCE_KERNELS:
            raise ValueError(f"op {op.op_type!r}: reference kernel tag "
                             f"{tag!r} has no counterpart here")
        op.attrs["kernel"] = REFERENCE_KERNELS[tag]
    g.rebuild_links()
    return g
