"""Fluid (``__model__``) model format — the reference's front door.

Port of ``paddle_lite_tpu/formats/fluid.py`` (the capability of
``lite/model_parser/model_parser.cc``'s ``LoadModelPb``: a directory with
a ``__model__`` ProgramDesc protobuf plus either per-var param files or a
combined ``params`` file), with no protobuf or paddle dependency: the wire
format is parsed with ``formats/protowire.py`` against the fluid
``framework.proto`` schema.

Two layers here (the converter is ``formats/fluid_convert.py``):

1.  Desc model: :class:`FluidProgram` / :class:`FluidBlock` /
    :class:`FluidOp` / :class:`FluidVar` (``:104-158`` there) — the
    ``cpp::ProgramDesc`` analog, decoupled from the wire format.
2.  Codec: :func:`parse_program` / :func:`serialize_program` (wire <->
    desc) and the LoDTensor param codec (:func:`parse_lod_tensor` /
    :func:`serialize_lod_tensor`, the ``SerializeToStream`` layout: u32
    version, u64 lod_level, lod vectors, u32 tensor version, i32 desc size,
    TensorDesc proto, raw data); combined and per-var params;
    :func:`load_fluid_dir` / :func:`save_fluid_dir`.

Params come back as numpy arrays, as ``Graph.weights`` holds them.  The
serializer exists for round-trip tests and for writing programs at run time
(``testing/fluid_programs.py``): no real paddle checkpoint is downloaded.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import Precision
from . import protowire as w

# ---- framework.proto schema constants --------------------------------------

# OpDesc.Attr.AttrType
ATTR_INT = 0
ATTR_FLOAT = 1
ATTR_STRING = 2
ATTR_INTS = 3
ATTR_FLOATS = 4
ATTR_STRINGS = 5
ATTR_BOOLEAN = 6
ATTR_BOOLEANS = 7
ATTR_BLOCK = 8
ATTR_LONG = 9
ATTR_BLOCKS = 10
ATTR_LONGS = 11

# VarType.Type (fluid); tensor dtypes + container kinds
VT_BOOL = 0
VT_INT16 = 1
VT_INT32 = 2
VT_INT64 = 3
VT_FP16 = 4
VT_FP32 = 5
VT_FP64 = 6
VT_LOD_TENSOR = 7
VT_SELECTED_ROWS = 8
VT_FEED_MINIBATCH = 9
VT_FETCH_LIST = 10
VT_STEP_SCOPES = 11
VT_LOD_RANK_TABLE = 12
VT_LOD_TENSOR_ARRAY = 13
VT_PLACE_LIST = 14
VT_READER = 15
VT_RAW = 17
VT_UINT8 = 20
VT_INT8 = 21

_VT_TO_NP = {
    VT_BOOL: np.bool_,
    VT_INT16: np.int16,
    VT_INT32: np.int32,
    VT_INT64: np.int64,
    VT_FP16: np.float16,
    VT_FP32: np.float32,
    VT_FP64: np.float64,
    VT_UINT8: np.uint8,
    VT_INT8: np.int8,
}
_NP_TO_VT = {np.dtype(v): k for k, v in _VT_TO_NP.items()}

_VT_TO_PRECISION = {
    VT_FP32: Precision.FP32,
    VT_INT8: Precision.INT8,
    VT_INT32: Precision.INT32,
    VT_INT64: Precision.INT64,
    VT_BOOL: Precision.BOOL,
}


class FluidFormatError(ValueError):
    pass


# ---- desc model --------------------------------------------------------------

@dataclasses.dataclass
class FluidVar:
    name: str
    shape: Tuple[int, ...] = ()
    dtype: int = VT_FP32                # VarType.Type of the tensor payload
    kind: int = VT_LOD_TENSOR           # container kind (lod_tensor etc.)
    persistable: bool = False
    lod_level: int = 0


@dataclasses.dataclass
class FluidOp:
    type: str
    inputs: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    outputs: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    attr_types: Dict[str, int] = dataclasses.field(default_factory=dict)

    def input(self, slot: str, i: int = 0) -> str:
        return self.inputs[slot][i]

    def maybe_input(self, slot: str) -> Optional[str]:
        ns = self.inputs.get(slot)
        return ns[0] if ns else None

    def output(self, slot: str, i: int = 0) -> str:
        return self.outputs[slot][i]


@dataclasses.dataclass
class FluidBlock:
    idx: int = 0
    parent_idx: int = 0
    vars: Dict[str, FluidVar] = dataclasses.field(default_factory=dict)
    ops: List[FluidOp] = dataclasses.field(default_factory=list)
    forward_block_idx: int = -1


@dataclasses.dataclass
class FluidProgram:
    blocks: List[FluidBlock] = dataclasses.field(default_factory=list)
    version: int = 0

    @property
    def main(self) -> FluidBlock:
        return self.blocks[0]


# ---- wire -> desc -------------------------------------------------------------

def _parse_attr(buf: bytes) -> Tuple[str, int, Any]:
    name = ""
    atype = ATTR_INT
    scalar: Any = None
    ints: List[int] = []
    floats: List[float] = []
    strings: List[str] = []
    bools: List[bool] = []
    longs: List[int] = []
    for field, wire, val in w.iter_fields(buf):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:
            atype = val
        elif field == 3:    # i
            scalar = w.to_signed(val)
        elif field == 4:    # f
            scalar = w.as_float(val)
        elif field == 5:    # s
            scalar = val.decode("utf-8")
        elif field == 6:    # ints
            if wire == w.WIRE_BYTES:
                ints.extend(w.unpack_varints(val))
            else:
                ints.append(w.to_signed(val))
        elif field == 7:    # floats
            if wire == w.WIRE_BYTES:
                floats.extend(w.unpack_floats(val))
            else:
                floats.append(w.as_float(val))
        elif field == 8:    # strings
            strings.append(val.decode("utf-8"))
        elif field == 10:   # b
            scalar = bool(val)
        elif field == 11:   # bools
            if wire == w.WIRE_BYTES:
                bools.extend(bool(x) for x in w.unpack_varints(val, signed=False))
            else:
                bools.append(bool(val))
        elif field == 12:   # block_idx
            scalar = w.to_signed(val)
        elif field == 13:   # l
            scalar = w.to_signed(val)
        elif field == 14:   # blocks_idx
            if wire == w.WIRE_BYTES:
                ints.extend(w.unpack_varints(val))
            else:
                ints.append(w.to_signed(val))
        elif field == 15:   # longs
            if wire == w.WIRE_BYTES:
                longs.extend(w.unpack_varints(val))
            else:
                longs.append(w.to_signed(val))
    value: Any
    if atype in (ATTR_INT, ATTR_LONG, ATTR_BLOCK):
        value = int(scalar or 0)
    elif atype == ATTR_FLOAT:
        value = float(scalar or 0.0)
    elif atype == ATTR_STRING:
        value = scalar or ""
    elif atype == ATTR_BOOLEAN:
        value = bool(scalar)
    elif atype == ATTR_INTS or atype == ATTR_BLOCKS:
        value = ints
    elif atype == ATTR_FLOATS:
        value = floats
    elif atype == ATTR_STRINGS:
        value = strings
    elif atype == ATTR_BOOLEANS:
        value = bools
    elif atype == ATTR_LONGS:
        value = longs
    else:
        raise FluidFormatError(f"unsupported attr type {atype} ({name})")
    return name, atype, value


def _parse_op_var(buf: bytes) -> Tuple[str, List[str]]:
    param = ""
    args: List[str] = []
    for field, _, val in w.iter_fields(buf):
        if field == 1:
            param = val.decode("utf-8")
        elif field == 2:
            args.append(val.decode("utf-8"))
    return param, args


def _parse_op(buf: bytes) -> FluidOp:
    op = FluidOp(type="")
    for field, _, val in w.iter_fields(buf):
        if field == 1:
            slot, args = _parse_op_var(val)
            op.inputs[slot] = args
        elif field == 2:
            slot, args = _parse_op_var(val)
            op.outputs[slot] = args
        elif field == 3:
            op.type = val.decode("utf-8")
        elif field == 4:
            name, atype, value = _parse_attr(val)
            op.attrs[name] = value
            op.attr_types[name] = atype
    return op


def _parse_tensor_desc(buf: bytes) -> Tuple[int, Tuple[int, ...]]:
    dtype = VT_FP32
    dims: List[int] = []
    for field, wire, val in w.iter_fields(buf):
        if field == 1:
            dtype = val
        elif field == 2:
            if wire == w.WIRE_BYTES:
                dims.extend(w.unpack_varints(val))
            else:
                dims.append(w.to_signed(val))
    return dtype, tuple(dims)


def _parse_var_type(buf: bytes) -> Tuple[int, int, Tuple[int, ...], int]:
    """Returns (kind, dtype, dims, lod_level)."""
    kind = VT_LOD_TENSOR
    dtype = VT_FP32
    dims: Tuple[int, ...] = ()
    lod_level = 0
    for field, _, val in w.iter_fields(buf):
        if field == 1:
            kind = val
        elif field == 2:  # selected_rows: TensorDesc
            dtype, dims = _parse_tensor_desc(val)
        elif field == 3:  # lod_tensor: LoDTensorDesc
            for f2, _, v2 in w.iter_fields(val):
                if f2 == 1:
                    dtype, dims = _parse_tensor_desc(v2)
                elif f2 == 2:
                    lod_level = w.to_signed(v2)
        elif field == 4:  # tensor_array
            for f2, _, v2 in w.iter_fields(val):
                if f2 == 1:
                    dtype, dims = _parse_tensor_desc(v2)
    return kind, dtype, dims, lod_level


def _parse_var(buf: bytes) -> FluidVar:
    var = FluidVar(name="")
    for field, _, val in w.iter_fields(buf):
        if field == 1:
            var.name = val.decode("utf-8")
        elif field == 2:
            var.kind, var.dtype, var.shape, var.lod_level = _parse_var_type(val)
        elif field == 3:
            var.persistable = bool(val)
    return var


def _parse_block(buf: bytes) -> FluidBlock:
    blk = FluidBlock()
    for field, _, val in w.iter_fields(buf):
        if field == 1:
            blk.idx = w.to_signed(val)
        elif field == 2:
            blk.parent_idx = w.to_signed(val)
        elif field == 3:
            v = _parse_var(val)
            blk.vars[v.name] = v
        elif field == 4:
            blk.ops.append(_parse_op(val))
        elif field == 5:
            blk.forward_block_idx = w.to_signed(val)
    return blk


def parse_program(buf: bytes) -> FluidProgram:
    """``__model__`` bytes → :class:`FluidProgram`."""
    prog = FluidProgram()
    for field, _, val in w.iter_fields(buf):
        if field == 1:
            prog.blocks.append(_parse_block(val))
        elif field == 4:  # Version { int64 version = 1; }
            for f2, _, v2 in w.iter_fields(val):
                if f2 == 1:
                    prog.version = w.to_signed(v2)
    if not prog.blocks:
        raise FluidFormatError("program has no blocks")
    return prog


# ---- desc -> wire -------------------------------------------------------------

def _infer_attr_type(value: Any) -> int:
    if isinstance(value, bool):
        return ATTR_BOOLEAN
    if isinstance(value, int):
        return ATTR_INT
    if isinstance(value, float):
        return ATTR_FLOAT
    if isinstance(value, str):
        return ATTR_STRING
    if isinstance(value, (list, tuple)):
        if value and isinstance(value[0], bool):
            return ATTR_BOOLEANS
        if value and isinstance(value[0], float):
            return ATTR_FLOATS
        if value and isinstance(value[0], str):
            return ATTR_STRINGS
        return ATTR_INTS
    raise FluidFormatError(f"cannot infer attr type for {value!r}")


def _emit_attr(name: str, atype: int, value: Any) -> bytes:
    body = w.emit_bytes(1, name) + w.emit_varint(2, atype)
    if atype == ATTR_INT:
        body += w.emit_varint(3, value)
    elif atype == ATTR_FLOAT:
        body += w.emit_float(4, value)
    elif atype == ATTR_STRING:
        body += w.emit_bytes(5, value)
    elif atype == ATTR_INTS:
        body += w.emit_repeated_varints(6, value)
    elif atype == ATTR_FLOATS:
        body += w.emit_repeated_floats(7, value)
    elif atype == ATTR_STRINGS:
        body += b"".join(w.emit_bytes(8, s) for s in value)
    elif atype == ATTR_BOOLEAN:
        body += w.emit_varint(10, value)
    elif atype == ATTR_BOOLEANS:
        body += w.emit_repeated_varints(11, value)
    elif atype == ATTR_BLOCK:
        body += w.emit_varint(12, value)
    elif atype == ATTR_LONG:
        body += w.emit_varint(13, value)
    elif atype == ATTR_BLOCKS:
        body += w.emit_repeated_varints(14, value)
    elif atype == ATTR_LONGS:
        body += w.emit_repeated_varints(15, value)
    else:
        raise FluidFormatError(f"unsupported attr type {atype}")
    return body


def _emit_op(op: FluidOp) -> bytes:
    body = b""
    for slot, args in op.inputs.items():
        vb = w.emit_bytes(1, slot) + b"".join(w.emit_bytes(2, a) for a in args)
        body += w.emit_message(1, vb)
    for slot, args in op.outputs.items():
        vb = w.emit_bytes(1, slot) + b"".join(w.emit_bytes(2, a) for a in args)
        body += w.emit_message(2, vb)
    body += w.emit_bytes(3, op.type)
    for name, value in op.attrs.items():
        atype = op.attr_types.get(name, _infer_attr_type(value))
        body += w.emit_message(4, _emit_attr(name, atype, value))
    return body


def _emit_tensor_desc(dtype: int, dims: Sequence[int]) -> bytes:
    return w.emit_varint(1, dtype) + w.emit_repeated_varints(2, dims)


def _emit_var(var: FluidVar) -> bytes:
    if var.kind == VT_LOD_TENSOR:
        inner = w.emit_message(1, _emit_tensor_desc(var.dtype, var.shape))
        if var.lod_level:
            inner += w.emit_varint(2, var.lod_level)
        vt = w.emit_varint(1, var.kind) + w.emit_message(3, inner)
    elif var.kind in (VT_FEED_MINIBATCH, VT_FETCH_LIST, VT_STEP_SCOPES, VT_RAW):
        vt = w.emit_varint(1, var.kind)
    else:
        vt = w.emit_varint(1, var.kind) + w.emit_message(
            2, _emit_tensor_desc(var.dtype, var.shape))
    body = w.emit_bytes(1, var.name) + w.emit_message(2, vt)
    if var.persistable:
        body += w.emit_varint(3, True)
    return body


def serialize_program(prog: FluidProgram) -> bytes:
    out = b""
    for blk in prog.blocks:
        body = w.emit_varint(1, blk.idx) + w.emit_varint(2, blk.parent_idx)
        for var in blk.vars.values():
            body += w.emit_message(3, _emit_var(var))
        for op in blk.ops:
            body += w.emit_message(4, _emit_op(op))
        if blk.forward_block_idx != -1:
            body += w.emit_varint(5, blk.forward_block_idx)
        out += w.emit_message(1, body)
    if prog.version:
        out += w.emit_message(4, w.emit_varint(1, prog.version))
    return out


# ---- LoDTensor param codec ----------------------------------------------------

def parse_lod_tensor(buf: bytes, pos: int = 0) -> Tuple[np.ndarray, int]:
    """One serialized LoDTensor (framework ``SerializeToStream`` layout)."""
    (version,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if version != 0:
        raise FluidFormatError(f"unsupported LoDTensor version {version}")
    (lod_level,) = struct.unpack_from("<Q", buf, pos)
    pos += 8
    for _ in range(lod_level):
        (size,) = struct.unpack_from("<Q", buf, pos)
        pos += 8 + size  # lod offsets; ragged seqs are handled by bucketing
    (tversion,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if tversion != 0:
        raise FluidFormatError(f"unsupported tensor version {tversion}")
    (desc_size,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    dtype, dims = _parse_tensor_desc(buf[pos:pos + desc_size])
    pos += desc_size
    np_dtype = _VT_TO_NP.get(dtype)
    if np_dtype is None:
        raise FluidFormatError(f"unsupported tensor dtype {dtype}")
    count = int(np.prod(dims)) if dims else 1
    nbytes = count * np.dtype(np_dtype).itemsize
    arr = np.frombuffer(buf, dtype=np_dtype, count=count, offset=pos)
    pos += nbytes
    return arr.reshape(dims).copy(), pos


def serialize_lod_tensor(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    vt = _NP_TO_VT.get(arr.dtype)
    if vt is None:
        raise FluidFormatError(f"unsupported param dtype {arr.dtype}")
    desc = _emit_tensor_desc(vt, arr.shape)
    return (struct.pack("<I", 0) + struct.pack("<Q", 0)
            + struct.pack("<I", 0) + struct.pack("<i", len(desc))
            + desc + arr.tobytes())


def combined_param_order(prog: FluidProgram) -> List[str]:
    """Order of tensors in a combined ``params`` file: persistable vars of
    the main block, sorted by name (the ``LoadCombinedParamsPb`` contract;
    feed/fetch plumbing vars excluded)."""
    skip_kinds = (VT_FEED_MINIBATCH, VT_FETCH_LIST, VT_STEP_SCOPES, VT_RAW)
    return sorted(
        v.name for v in prog.main.vars.values()
        if v.persistable and v.kind not in skip_kinds
    )


def parse_combined_params(prog: FluidProgram, buf: bytes) -> Dict[str, np.ndarray]:
    params: Dict[str, np.ndarray] = {}
    pos = 0
    for name in combined_param_order(prog):
        params[name], pos = parse_lod_tensor(buf, pos)
    if pos != len(buf):
        raise FluidFormatError(
            f"{len(buf) - pos} trailing bytes in combined params")
    return params


def serialize_combined_params(prog: FluidProgram,
                              params: Dict[str, np.ndarray]) -> bytes:
    return b"".join(
        serialize_lod_tensor(params[name]) for name in combined_param_order(prog)
    )


# ---- directory I/O ------------------------------------------------------------

def load_fluid_dir(path: str) -> Tuple[FluidProgram, Dict[str, np.ndarray]]:
    """Load a fluid model directory: ``__model__`` + combined ``params`` /
    ``__params__``, or per-var files named by var name."""
    model_file = None
    for cand in ("__model__", "model"):
        p = os.path.join(path, cand)
        if os.path.isfile(p):
            model_file = p
            break
    if model_file is None:
        raise FluidFormatError(f"no __model__ in {path}")
    with open(model_file, "rb") as f:
        prog = parse_program(f.read())

    params: Dict[str, np.ndarray] = {}
    combined = None
    for cand in ("params", "__params__"):
        p = os.path.join(path, cand)
        if os.path.isfile(p):
            combined = p
            break
    if combined is not None:
        with open(combined, "rb") as f:
            params = parse_combined_params(prog, f.read())
    else:
        for name in combined_param_order(prog):
            p = os.path.join(path, name)
            if not os.path.isfile(p):
                raise FluidFormatError(f"missing param file {name}")
            with open(p, "rb") as f:
                params[name], _ = parse_lod_tensor(f.read())
    return prog, params


def save_fluid_dir(path: str, prog: FluidProgram,
                   params: Dict[str, np.ndarray], combined: bool = True) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "__model__"), "wb") as f:
        f.write(serialize_program(prog))
    if combined:
        with open(os.path.join(path, "params"), "wb") as f:
            f.write(serialize_combined_params(prog, params))
    else:
        for name in combined_param_order(prog):
            with open(os.path.join(path, name), "wb") as f:
                f.write(serialize_lod_tensor(params[name]))
