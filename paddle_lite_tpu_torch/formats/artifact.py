"""Optimized-model artifact save/load — the ``.nb`` analog.

Port of ``paddle_lite_tpu/formats/artifact.py`` (``:30-244``), the analog of
``lite/model_parser/model_parser.cc``'s ``SaveModelNaive`` /
``LoadModelNaive``: an *optimized* graph (post-fusion, post-quantization:
int8 weights already packed, scales stamped) is written so that the light
path (``runtime.predictor.load_predictor``) runs no optimizer and no
calibration.  The container is the native ``nbf`` library
(``native/nbf.cc``, the reference's file layout and magic); the graph
travels as JSON in the meta section, the weights as 64-byte-aligned raw
blobs, each with its CRC32.

One file format for both packages.  The meta stores the reference's kernel
vocabulary: ``"torch"`` is written as ``"xla"`` and ``"cuda"`` as
``"pallas"``, and read back the other way (:data:`REFERENCE_KERNELS`), so an
artifact written by either package loads in the other.  The JAX package
cannot be taught the port's tags: its registry would run its default impl
for an unknown tag without a word.  A tag with no counterpart raises.

The graph <-> JSON half (:func:`graph_to_meta`, :func:`graph_from_meta`) is
also how ``formats/interop.graph_from_reference`` carries a graph optimized
by the JAX package across.
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict, List

import numpy as np

from ..core.ir import Graph, VarNode
from ..core.types import DataLayout, Precision, QuantInfo, TensorType
from ..native.build import load_library

FORMAT_VERSION = 1

# the reference's kernel tags -> the port's, and back
REFERENCE_KERNELS = {"xla": "torch", "pallas": "cuda"}
PORT_KERNELS = {v: k for k, v in REFERENCE_KERNELS.items()}


def _retag(tag, table: Dict[str, str], what: str, op_type: str):
    if tag is None:
        return None
    if tag not in table:
        raise ValueError(f"op {op_type!r}: {what} kernel tag {tag!r} has no "
                         f"counterpart (known: {sorted(table)})")
    return table[tag]


# ---- graph <-> json -------------------------------------------------------

def _quant_to_json(q: QuantInfo):
    if q is None:
        return None
    j = {"scale": list(q.scale), "axis": q.axis, "bits": q.bits}
    if q.pack_axis is not None:  # W4 packed storage
        j["pack_axis"] = q.pack_axis
    return j


def _quant_from_json(j):
    if j is None:
        return None
    return QuantInfo(scale=tuple(j["scale"]), axis=j["axis"], bits=j["bits"],
                     pack_axis=j.get("pack_axis"))


def _ndarray_json(v: np.ndarray) -> dict:
    return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}


def _jsonable_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = _ndarray_json(v)
        elif isinstance(v, Graph):
            # nested graphs (control-flow bodies); their weights inline
            out[k] = {"__graph__": graph_to_meta(v),
                      "weights": {n: _ndarray_json(w) for n, w in v.weights.items()}}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        elif isinstance(v, tuple):
            out[k] = list(v)
        else:
            out[k] = v
    return out


def _op_attrs_to_json(op) -> dict:
    attrs = _jsonable_attrs(op.attrs)
    if "kernel" in attrs:
        attrs["kernel"] = _retag(attrs["kernel"], PORT_KERNELS, "the port's",
                                 op.op_type)
    return attrs


def graph_to_meta(graph: Graph) -> dict:
    """The reference's meta of `graph`, kernel tags in its vocabulary."""
    return {
        "format_version": FORMAT_VERSION,
        "name": graph.name,
        "meta": dict(graph.meta),
        "inputs": graph.inputs,
        "outputs": graph.outputs,
        "vars": {
            name: {
                "shape": list(v.shape),
                "precision": v.precision.value,
                "layout": v.ttype.layout.value,
                "is_weight": v.is_weight,
                "quant": _quant_to_json(v.quant),
            }
            for name, v in graph.vars.items()
        },
        "ops": [
            {"type": op.op_type, "inputs": op.inputs, "outputs": op.outputs,
             "attrs": _op_attrs_to_json(op)}
            for op in graph.ops
        ],
    }


def _attrs_from_json(attrs: dict, op_type: str) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=np.dtype(v["dtype"]))
        elif isinstance(v, dict) and "__graph__" in v:
            g = graph_from_meta(v["__graph__"])
            g.weights = {n: np.asarray(w["__ndarray__"], dtype=np.dtype(w["dtype"]))
                         for n, w in v["weights"].items()}
            g.rebuild_links()
            out[k] = g
        else:
            out[k] = v
    if "kernel" in out:
        out["kernel"] = _retag(out["kernel"], REFERENCE_KERNELS, "the reference's",
                               op_type)
    return out


def graph_from_meta(meta: dict) -> Graph:
    """A Graph from the reference's meta (no weights), kernel tags mapped
    to the port's."""
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"artifact format version {meta.get('format_version')} "
            f"not supported (expected {FORMAT_VERSION})")
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
        g.add_op(oj["type"], oj["inputs"], oj["outputs"],
                 _attrs_from_json(oj["attrs"], oj["type"]))
    g.inputs = list(meta["inputs"])
    g.outputs = list(meta["outputs"])
    g.meta = dict(meta.get("meta", {}))
    return g


# ---- native nbf binding ---------------------------------------------------

def _nbf() -> ctypes.CDLL:
    lib = load_library("nbf")
    lib.nbf_last_error.restype = ctypes.c_char_p
    lib.nbf_write.restype = ctypes.c_int
    lib.nbf_write.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
    ]
    lib.nbf_read_meta_len.restype = ctypes.c_uint64
    lib.nbf_read_meta_len.argtypes = [ctypes.c_char_p]
    lib.nbf_read_meta.restype = ctypes.c_int
    lib.nbf_read_meta.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.nbf_read_blob.restype = ctypes.c_int
    lib.nbf_read_blob.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_uint32,
    ]
    lib.nbf_blob_offset.restype = ctypes.c_uint64
    lib.nbf_blob_offset.argtypes = [
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
    lib.nbf_crc32.restype = ctypes.c_uint32
    lib.nbf_crc32.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    return lib


def _err(lib) -> str:
    return lib.nbf_last_error().decode()


# ---- save/load ------------------------------------------------------------

def save(graph: Graph, path: str) -> None:
    """Write `graph` (with its weights) to `path` as the reference does,
    byte for byte: the same meta JSON, the same blob order and offsets."""
    lib = _nbf()
    names = sorted(graph.weights)
    arrays = [np.ascontiguousarray(graph.weights[n]) for n in names]
    sizes = (ctypes.c_uint64 * len(arrays))(*[a.nbytes for a in arrays])

    meta = graph_to_meta(graph)
    manifest: List[dict] = [
        {"name": n, "dtype": str(a.dtype), "shape": list(a.shape), "offset": 0,
         "nbytes": int(a.nbytes),
         "crc32": int(lib.nbf_crc32(a.ctypes.data_as(ctypes.c_void_p), a.nbytes))}
        for n, a in zip(names, arrays)]
    meta["tensors"] = manifest

    def meta_bytes() -> bytes:
        return json.dumps(meta, separators=(",", ":")).encode()

    # the offsets depend on the meta's length, which holds them: iterate
    # until the digits settle (a few rounds at most)
    for _ in range(8):
        mlen = len(meta_bytes())
        changed = False
        for i, t in enumerate(manifest):
            off = int(lib.nbf_blob_offset(mlen, sizes, i))
            if t["offset"] != off:
                t["offset"] = off
                changed = True
        if not changed:
            break
    mb = meta_bytes()
    blob_ptrs = (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])
    rc = lib.nbf_write(path.encode(), mb, len(mb), blob_ptrs, sizes, len(arrays))
    if rc != 0:
        raise IOError(f"nbf_write failed ({rc}): {_err(lib)}")


def load_meta(path: str) -> dict:
    """The artifact's meta JSON as written (the reference's kernel tags),
    after its header and meta CRC checks."""
    lib = _nbf()
    mlen = lib.nbf_read_meta_len(path.encode())
    if mlen == 0:
        raise IOError(f"bad artifact {path}: {_err(lib)}")
    buf = ctypes.create_string_buffer(mlen)
    rc = lib.nbf_read_meta(path.encode(), buf, mlen)
    if rc != 0:
        raise IOError(f"bad artifact meta {path} ({rc}): {_err(lib)}")
    return json.loads(buf.raw[:mlen].decode())


def load(path: str) -> Graph:
    """The graph of an artifact written by either package, its weights
    CRC-checked; raises ``IOError`` on a bad magic, a truncated file or a
    corrupt blob."""
    lib = _nbf()
    meta = load_meta(path)
    g = graph_from_meta(meta)
    for t in meta["tensors"]:
        a = np.empty(tuple(t["shape"]), dtype=np.dtype(t["dtype"]))
        if a.nbytes != t["nbytes"]:
            raise IOError(f"tensor {t['name']}: size mismatch")
        rc = lib.nbf_read_blob(path.encode(), t["offset"], t["nbytes"],
                               a.ctypes.data_as(ctypes.c_void_p), t["crc32"])
        if rc != 0:
            raise IOError(f"tensor {t['name']} corrupt ({rc}): {_err(lib)}")
        g.weights[t["name"]] = a
    g.rebuild_links()
    return g
