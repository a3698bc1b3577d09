"""The fluid front door through both packages: the codec, the writer and
the converter.

The codec (``formats/{protowire,fluid}.py``): the port parses the four
committed fixtures (``tests/fixtures/{mnv1_fluid,qat_lenet,qat_ssd_head,
crnn_fluid}``) into the reference's descs and params, serializes them back
to the same bytes, and its writer (``testing/fluid_programs.py``) writes
``mnv1_fluid`` byte for byte.

The converter (``formats/fluid_convert.py``): for the fixtures and for the
programs of ``tests/test_fluid.py`` (the conv/pool/fc program, the NHWC
transpose alias, the transformer block), the port's graph equals the
reference's — ``artifact.graph_to_meta`` of both (the same JSON: ops in
order, attrs, var shapes, precisions, layouts) and the weights bit for bit.
Tolerances:
- unoptimized fp32 outputs of both graphs: rtol 1e-5, atol 1e-6;
- after ``optimize()`` in both on the same calibration batch (PTQ) or with
  none (the QAT fixtures, through ``quant_dequant_fuse``): the same graph,
  scales and int8 weights bit for bit; the port's ops run on the inputs the
  reference's run gave each of them: int8 outputs within the 1-LSB tie rule
  (``paddle_lite_tpu_torch.testing``), fp32 outputs within rtol 1e-5, atol
  1e-6; end to end, softmax outputs within 1e-3 (``testing.SOFTMAX_ATOL``),
  detections equal, CRNN's greedy decodes equal.
"""

import copy
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu.formats import fluid as RF
from paddle_lite_tpu.formats import fluid_convert as r_convert
from paddle_lite_tpu.formats import protowire as r_wire
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core.executor import ExecutionContext
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats import artifact as p_artifact
from paddle_lite_tpu_torch.formats import fluid as PF
from paddle_lite_tpu_torch.formats import fluid_convert as p_convert
from paddle_lite_tpu_torch.formats import protowire as p_wire
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.testing import fluid_programs
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
HERE = os.path.dirname(__file__)
FIXTURES = {name: os.path.join(HERE, "fixtures", name)
            for name in ("mnv1_fluid", "qat_lenet", "qat_ssd_head", "crnn_fluid")}
BATCH = 2
RTOL, ATOL = 1e-5, 1e-6


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---- the codec --------------------------------------------------------------------

def _desc(prog):
    """A plain, comparable form of either package's program desc."""
    return {
        "version": prog.version,
        "blocks": [{
            "idx": b.idx, "parent": b.parent_idx, "forward": b.forward_block_idx,
            "vars": [(v.name, tuple(v.shape), v.dtype, v.kind, v.persistable,
                      v.lod_level) for v in b.vars.values()],
            "ops": [(op.type, op.inputs, op.outputs,
                     [(k, op.attr_types[k], repr(v)) for k, v in op.attrs.items()])
                    for op in b.ops],
        } for b in prog.blocks],
    }


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_parse_matches_reference(name):
    buf = _read(os.path.join(FIXTURES[name], "__model__"))
    assert _desc(PF.parse_program(buf)) == _desc(RF.parse_program(buf))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_params_match_reference(name):
    _, want = RF.load_fluid_dir(FIXTURES[name])
    _, got = PF.load_fluid_dir(FIXTURES[name])
    assert list(got) == list(want)
    for n, w in want.items():
        assert got[n].dtype == w.dtype and got[n].shape == w.shape, n
        assert got[n].tobytes() == w.tobytes(), n


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_model_and_params_serialize_to_the_same_bytes(name):
    model = _read(os.path.join(FIXTURES[name], "__model__"))
    prog = PF.parse_program(model)
    assert PF.serialize_program(prog) == model
    params = _read(os.path.join(FIXTURES[name], "params"))
    assert PF.serialize_combined_params(prog, PF.parse_combined_params(prog, params)) == params


def test_writer_reproduces_the_committed_fixture(tmp_path):
    """The port's MobileNetV1 writer at the fixture script's arguments
    (width 0.25, 96 px, 100 classes, seed 7) writes its bytes."""
    out = tmp_path / "mnv1"
    fluid_programs.write_mobilenet_v1(str(out), width=0.25, image_size=96,
                                      classes=100, seed=7)
    for f in ("__model__", "params"):
        assert _read(out / f) == _read(os.path.join(FIXTURES["mnv1_fluid"], f)), f


def _lod_tensor_bytes(arr, lod):
    """A serialized LoDTensor with `lod` levels (lists of offsets), as
    ``SerializeToStream`` lays it out; neither package writes lod levels."""
    body = struct.pack("<I", 0) + struct.pack("<Q", len(lod))
    for level in lod:
        body += struct.pack("<Q", 8 * len(level)) + struct.pack(f"<{len(level)}Q", *level)
    vt = {np.dtype(np.float32): RF.VT_FP32, np.dtype(np.int64): RF.VT_INT64,
          np.dtype(np.int8): RF.VT_INT8}[arr.dtype]
    desc = r_wire.emit_varint(1, vt) + r_wire.emit_repeated_varints(2, arr.shape)
    return body + struct.pack("<I", 0) + struct.pack("<i", len(desc)) + desc + arr.tobytes()


@pytest.mark.parametrize("lod", [[], [[0, 2, 5]], [[0, 1, 3], [0, 2, 3, 5]]],
                         ids=["lod0", "lod1", "lod2"])
@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.int8])
def test_lod_tensor_round_trip(lod, dtype):
    arr = (np.random.default_rng(5).normal(size=(5, 3)) * 50).astype(dtype)
    buf = _lod_tensor_bytes(arr, lod) + b"tail"
    got, pos = PF.parse_lod_tensor(buf)
    want, rpos = RF.parse_lod_tensor(buf)
    assert pos == rpos == len(buf) - 4
    assert got.dtype == want.dtype and np.array_equal(got, want) and np.array_equal(got, arr)
    if not lod:
        assert PF.serialize_lod_tensor(arr) == buf[:-4] == RF.serialize_lod_tensor(arr)


def test_per_var_param_files(tmp_path):
    prog, params = fluid_programs.mobilenet_v1_program(width=0.25, image_size=32,
                                                       classes=10, seed=3)
    d = tmp_path / "pervar"
    PF.save_fluid_dir(str(d), prog, params, combined=False)
    assert not (d / "params").exists()
    _, got = PF.load_fluid_dir(str(d))
    _, want = RF.load_fluid_dir(str(d))
    assert set(got) == set(want) == set(params)
    for n in params:
        assert got[n].tobytes() == want[n].tobytes() == params[n].tobytes(), n


def test_missing_model_or_param_file_raises(tmp_path):
    with pytest.raises(PF.FluidFormatError, match="no __model__"):
        PF.load_fluid_dir(str(tmp_path))
    prog, params = fluid_programs.mobilenet_v1_program(width=0.25, image_size=32,
                                                       classes=10)
    d = tmp_path / "pervar"
    PF.save_fluid_dir(str(d), prog, params, combined=False)
    os.remove(d / "fc_b")
    with pytest.raises(PF.FluidFormatError, match="missing param file fc_b"):
        PF.load_fluid_dir(str(d))


@pytest.mark.parametrize("v", [0, 1, 127, 128, 300, 2 ** 31 - 1, 2 ** 63 - 1, -1, -2 ** 31])
def test_protowire_varints_match_reference(v):
    enc = p_wire.write_varint(v)
    assert enc == r_wire.write_varint(v)
    got, pos = p_wire.read_varint(enc, 0)
    assert pos == len(enc) and p_wire.to_signed(got) == v


def test_truncated_wire_raises():
    with pytest.raises(p_wire.WireError, match="truncated"):
        list(p_wire.iter_fields(p_wire.emit_bytes(1, b"abcdef")[:-2]))


# ---- the programs of tests/test_fluid.py, built for both codecs ---------------------

def _feed_fetch(block, in_name, in_shape, out_name):
    block.vars["feed"] = RF.FluidVar("feed", kind=RF.VT_FEED_MINIBATCH)
    block.vars["fetch"] = RF.FluidVar("fetch", kind=RF.VT_FETCH_LIST)
    block.vars[in_name] = RF.FluidVar(in_name, shape=in_shape)
    block.ops.insert(0, RF.FluidOp("feed", {"X": ["feed"]}, {"Out": [in_name]}, {"col": 0}))
    block.ops.append(RF.FluidOp("fetch", {"X": [out_name]}, {"Out": ["fetch"]}, {"col": 0}))


def _var(block, name, shape, persistable=False):
    block.vars[name] = RF.FluidVar(name, shape=tuple(shape), persistable=persistable)


def small_cnn_program():
    from test_fluid import small_cnn_program as build

    return build(np.random.default_rng(11))


def transpose_alias_program():
    """``tests/test_fluid.py:172``: conv → transpose2 NCHW→NHWC → reshape2."""
    rng = np.random.default_rng(12)
    prog = RF.FluidProgram(blocks=[RF.FluidBlock()])
    b = prog.main
    params = {"w": rng.normal(0, 0.2, (12, 3, 1, 1)).astype(np.float32)}
    _var(b, "w", params["w"].shape, persistable=True)
    _var(b, "head", (-1, 12, 4, 4))
    _var(b, "head_t", (-1, 4, 4, 12))
    _var(b, "boxes", (-1, 48, 4))
    b.ops = [
        RF.FluidOp("conv2d", {"Input": ["image"], "Filter": ["w"]}, {"Output": ["head"]},
                   {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
                    "groups": 1}),
        RF.FluidOp("transpose2", {"X": ["head"]}, {"Out": ["head_t"]},
                   {"axis": [0, 2, 3, 1]}),
        RF.FluidOp("reshape2", {"X": ["head_t"]}, {"Out": ["boxes"]}, {"shape": [0, -1, 4]}),
    ]
    _feed_fetch(b, "image", (-1, 3, 4, 4), "boxes")
    return prog, params


def transformer_program():
    """``tests/test_fluid.py:307``: matmul / scale / softmax / residual
    add / layer_norm."""
    d_model, seq = 8, 4
    rng = np.random.default_rng(3)
    prog = RF.FluidProgram(blocks=[RF.FluidBlock()])
    b = prog.main
    params = {
        "wq": rng.normal(0, 0.2, (d_model, d_model)).astype(np.float32),
        "wk": rng.normal(0, 0.2, (d_model, d_model)).astype(np.float32),
        "wv": rng.normal(0, 0.2, (d_model, d_model)).astype(np.float32),
        "ln_g": np.abs(rng.normal(1, 0.1, (d_model,))).astype(np.float32),
        "ln_b": rng.normal(0, 0.05, (d_model,)).astype(np.float32),
    }
    for n, v in params.items():
        _var(b, n, v.shape, persistable=True)
    for n, s in [("q", (-1, seq, d_model)), ("k", (-1, seq, d_model)),
                 ("v", (-1, seq, d_model)), ("qk", (-1, seq, seq)),
                 ("qk_s", (-1, seq, seq)), ("attn", (-1, seq, seq)),
                 ("ctx", (-1, seq, d_model)), ("res", (-1, seq, d_model)),
                 ("ln", (-1, seq, d_model))]:
        _var(b, n, s)
    b.ops = [
        RF.FluidOp("matmul", {"X": ["x"], "Y": ["wq"]}, {"Out": ["q"]}, {}),
        RF.FluidOp("matmul", {"X": ["x"], "Y": ["wk"]}, {"Out": ["k"]}, {}),
        RF.FluidOp("matmul", {"X": ["x"], "Y": ["wv"]}, {"Out": ["v"]}, {}),
        RF.FluidOp("matmul", {"X": ["q"], "Y": ["k"]}, {"Out": ["qk"]}, {"transpose_Y": True}),
        RF.FluidOp("scale", {"X": ["qk"]}, {"Out": ["qk_s"]},
                   {"scale": float(1 / np.sqrt(d_model)), "bias": 0.0}),
        RF.FluidOp("softmax", {"X": ["qk_s"]}, {"Out": ["attn"]}, {"axis": -1}),
        RF.FluidOp("matmul", {"X": ["attn"], "Y": ["v"]}, {"Out": ["ctx"]}, {}),
        RF.FluidOp("elementwise_add", {"X": ["ctx"], "Y": ["x"]}, {"Out": ["res"]},
                   {"axis": -1}),
        RF.FluidOp("layer_norm", {"X": ["res"], "Scale": ["ln_g"], "Bias": ["ln_b"]},
                   {"Y": ["ln"]}, {"begin_norm_axis": 2, "epsilon": 1e-5}),
    ]
    _feed_fetch(b, "x", (-1, seq, d_model), "ln")
    return prog, params


PROGRAMS = {"small_cnn": small_cnn_program, "transpose_alias": transpose_alias_program,
            "transformer": transformer_program}
ALL = sorted(FIXTURES) + sorted(PROGRAMS)


def load_both(name, batch=BATCH):
    """(reference graph, port graph) converted from the same fluid bytes:
    a fixture directory, or a program serialized by the reference's codec
    and parsed by each package's."""
    if name in FIXTURES:
        return (r_convert.load_fluid_model(FIXTURES[name], batch=batch),
                p_convert.load_fluid_model(FIXTURES[name], batch=batch))
    prog, params = PROGRAMS[name]()
    buf = RF.serialize_program(prog)
    rprog, pprog = RF.parse_program(buf), PF.parse_program(buf)
    return (r_convert.fluid_to_graph(rprog, params, batch=batch, name=name),
            p_convert.fluid_to_graph(pprog, params, batch=batch, name=name))


def _input(g, seed):
    shape = g.vars[g.inputs[0]].shape
    return {g.inputs[0]: np.random.default_rng(seed).normal(size=shape).astype(np.float32)}


def _np(v):
    return np.asarray(jax.device_get(v))


def _run_ref(g, feed):
    return {k: _np(v) for k, v in R.build_callable(g, platform="cpu")(
        R.stage_weights(g), feed).items()}


def _run_port(g, feed):
    return {k: v.numpy() for k, v in P.build_callable(g, device=CPU)(
        P.stage_weights(g, CPU), feed).items()}


def assert_same_graph(gr, gp, skip_kernel=False):
    """The reference's meta of both graphs is the same JSON, and the
    weights are equal bit for bit."""
    mr, mp = r_artifact.graph_to_meta(gr), p_artifact.graph_to_meta(gp)
    if skip_kernel:
        for m in (mr, mp):
            for o in m["ops"]:
                o["attrs"].pop("kernel", None)
    assert json.dumps(mp) == json.dumps(mr)
    assert list(gp.weights) == list(gr.weights)
    for n, w in gr.weights.items():
        w = np.asarray(w)
        assert gp.weights[n].dtype == w.dtype and gp.weights[n].tobytes() == w.tobytes(), n


@pytest.mark.parametrize("name", ALL)
def test_converted_graph_equals_reference(name):
    gr, gp = load_both(name)
    assert_same_graph(gr, gp)


@pytest.mark.parametrize("name", ALL)
def test_unoptimized_fp32_outputs_agree(name):
    gr, gp = load_both(name)
    feed = _input(gr, 21)
    want, got = _run_ref(gr, feed), _run_port(gp, feed)
    for n in gr.outputs:
        if name == "qat_ssd_head":  # detections: the same (N, 100, 6) rows
            np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=1e-5)
        else:
            np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL)


def test_transpose_alias_is_an_assign():
    _, gp = load_both("transpose_alias")
    types = [op.op_type for op in gp.ops]
    assert types.count("transpose") == 1 and "assign" in types


# ---- after optimize() ----------------------------------------------------------------

QAT = ("qat_lenet", "qat_ssd_head")
OPTIMIZED = ["crnn_fluid", "mnv1_fluid", "qat_lenet", "qat_ssd_head", "small_cnn"]


def reference_calibration(gr, calib):
    """The reference's calibration of `gr` (after its fusion passes), as
    the port's ``CalibrationResult``."""
    from paddle_lite_tpu.core.pass_manager import PassManager as RPassManager
    from paddle_lite_tpu.quant.calibrate import calibrate as r_calibrate
    from paddle_lite_tpu.tools.opt import FUSION_PASSES as R_FUSION
    from paddle_lite_tpu_torch.quant.calibrate import CalibrationResult

    g = copy.deepcopy(gr)
    RPassManager(R_FUSION).run(g)
    return CalibrationResult(scales=dict(r_calibrate(g, calib).scales))


@pytest.fixture(scope="module", params=OPTIMIZED)
def optimized(request):
    """Both graphs after ``optimize()``: PTQ on one calibration batch (the
    port given the reference's activation ranges, so every scale can be
    held bit for bit; the port's own calibration is held to them in
    ``test_port_calibration_matches_reference``), or calibration-free for
    the QAT fixtures."""
    name = request.param
    gr, gp = load_both(name)
    if name in QAT:
        r_optimize(gr)
        optimize(gp, device="cpu")
    else:
        calib = [_input(gr, 1)]
        ranges = reference_calibration(gr, calib)
        r_optimize(gr, quant=R.QuantConfig(), calib_batches=calib)
        optimize(gp, quant=P.QuantConfig(), calib_result=ranges, device="cpu")
    return name, gr, gp


def test_optimized_graph_matches_reference(optimized):
    """The same ops, attrs, scales and int8 weights, bit for bit; only the
    kernel tags differ (the port picks its own kernels)."""
    name, gr, gp = optimized
    assert_same_graph(gr, gp, skip_kernel=True)
    assert any(op.attrs.get("enable_int8") for op in gp.ops)
    if name in QAT:
        assert not any(op.op_type.startswith("fake_") for op in gp.ops)


@pytest.mark.parametrize("name", ["crnn_fluid", "mnv1_fluid", "small_cnn"])
def test_port_calibration_matches_reference(name):
    """The port's own calibration on the card's path: the same graph, the
    activation scales within rtol 1e-5 (they are abs-maxes of fp32
    activations whose sums run in another order in XLA and in torch),
    weight scales and int8 weights bit for bit."""
    gr, gp = load_both(name)
    calib = [_input(gr, 1)]
    r_optimize(gr, quant=R.QuantConfig(), calib_batches=calib)
    optimize(gp, quant=P.QuantConfig(), calib_batches=calib, device="cpu")
    mr, mp = r_artifact.graph_to_meta(gr), p_artifact.graph_to_meta(gp)
    assert [(o["type"], o["inputs"], o["outputs"]) for o in mp["ops"]] == \
        [(o["type"], o["inputs"], o["outputs"]) for o in mr["ops"]]
    for a, b in zip(mr["ops"], mp["ops"]):
        ka = {k: v for k, v in a["attrs"].items() if k not in ("kernel", "out_scale")}
        kb = {k: v for k, v in b["attrs"].items() if k not in ("kernel", "out_scale")}
        assert ka == kb and ("out_scale" in a["attrs"]) == ("out_scale" in b["attrs"])
        if "out_scale" in a["attrs"]:
            np.testing.assert_allclose(b["attrs"]["out_scale"], a["attrs"]["out_scale"],
                                       rtol=1e-5)
    assert list(mp["vars"]) == list(mr["vars"])
    for n, v in mr["vars"].items():
        w = mp["vars"][n]
        assert {k: w[k] for k in w if k != "quant"} == {k: v[k] for k in v if k != "quant"}
        assert (w["quant"] is None) == (v["quant"] is None), n
        if v["quant"] is not None:
            np.testing.assert_allclose(w["quant"]["scale"], v["quant"]["scale"],
                                       rtol=0 if v["is_weight"] else 1e-5)
    for n, w in gr.weights.items():
        assert gp.weights[n].tobytes() == np.asarray(w).tobytes(), n


def _torch_of(v):
    return torch.from_numpy(np.array(_np(v)))


# ops whose fp32 output is a sum of products in fp32: an int8 conv whose
# activation input has no scale runs on its dequantized weight in fp32 (the
# QAT SSD head's five), and XLA and torch sum in another order
SUMS_IN_FP32 = ("conv2d", "depthwise_conv2d", "fc", "mul", "matmul")
MIXED_ATOL = 1e-6  # of the output's largest magnitude


def test_optimized_op_by_op_on_reference_inputs(optimized):
    """Each op of the port's optimized graph, run by the port on the inputs
    the reference's run gave it: int8 outputs within the tie rule, fp32
    within rtol 1e-5 and atol 1e-6 (a sum of products in fp32: atol 1e-6 of
    the output's largest magnitude), the rest equal."""
    name, gr, gp = optimized
    env = {}
    R.build_callable(gr, platform="cpu", capture=lambda n, v: env.__setitem__(n, v))(
        R.stage_weights(gr), _input(gr, 8))
    w = P.stage_weights(gp, CPU)
    ctx = ExecutionContext(graph=gp, device=CPU)
    diffs, n_ops = [], 0
    for op in gp.topological_order():
        ins = {s: [_torch_of(env[n]) if n in env else w[n] for n in ns]
               for s, ns in op.inputs.items() if ns}
        outs = OPS.get(op.op_type).impl_for(op.attrs.get("kernel"))(ctx, op, ins)
        for slot, arrs in outs.items():
            for n, a in zip(op.outputs[slot], arrs):
                r = _torch_of(env[n])
                if r.dtype == torch.int32 and a.dtype == torch.int64:
                    r = r.to(torch.int64)  # jax without x64
                assert a.dtype == r.dtype and a.shape == r.shape, (op.op_type, n)
                if a.dtype == torch.int8:
                    diffs.append(testing._diff(a, r))
                elif a.dtype == torch.float32:
                    scale = float(r.abs().max()) if r.numel() else 0.0
                    atol = MIXED_ATOL * scale if op.op_type in SUMS_IN_FP32 else ATOL
                    torch.testing.assert_close(a, r, rtol=RTOL, atol=atol,
                                               msg=f"{op.op_type} {n}")
                else:
                    assert torch.equal(a, r), (op.op_type, n)
        n_ops += 1
    assert n_ops == len(gr.ops) and diffs
    assert testing.within_tie_bound(diffs), [d for d in diffs if d["n_diff"]]


def _greedy(probs):
    """CTC greedy decode: per-step argmax, repeats merged, blank 0 dropped."""
    out = []
    for row in probs.argmax(-1):
        seq = [int(c) for i, c in enumerate(row) if c and (i == 0 or c != row[i - 1])]
        out.append(seq)
    return out


def _match(a, b, iou_min=0.5):
    """Rows of `a` (label, score, x1, y1, x2, y2; label -1 padding) with a
    row of `b` of the same label at IoU >= iou_min."""
    a, b = a[a[:, 0] >= 0], b[b[:, 0] >= 0]
    hit = 0
    for r in a:
        same = b[b[:, 0] == r[0]]
        ix = np.clip(np.minimum(r[4], same[:, 4]) - np.maximum(r[2], same[:, 2]), 0, None)
        iy = np.clip(np.minimum(r[5], same[:, 5]) - np.maximum(r[3], same[:, 3]), 0, None)
        area = lambda x: (x[..., 4] - x[..., 2]) * (x[..., 5] - x[..., 3])
        iou = ix * iy / (area(r) + area(same) - ix * iy + 1e-12)
        hit += bool((iou >= iou_min).any())
    return hit, len(a)


def test_optimized_outputs_agree(optimized):
    """End to end on a new input: softmax outputs within
    ``testing.SOFTMAX_ATOL`` (1e-3), the same top-1; the SSD head's
    detections each found in the other's; CRNN's greedy decodes equal."""
    name, gr, gp = optimized
    feed = _input(gr, 9)
    want, got = _run_ref(gr, feed), _run_port(gp, feed)
    out = gr.outputs[0]
    if name == "qat_ssd_head":
        for b in range(BATCH):
            hit, n = _match(got[out][b], want[out][b])
            back, m = _match(want[out][b], got[out][b])
            assert n > 0 and hit == n and back == m, (hit, n, back, m)
        return
    np.testing.assert_allclose(got[out], want[out], rtol=0, atol=testing.SOFTMAX_ATOL)
    assert (got[out].argmax(-1) == want[out].argmax(-1)).all()
    if name == "crnn_fluid":
        assert _greedy(got[out]) == _greedy(want[out])


def test_crnn_int8_decodes_track_fp32():
    """The reference's bar (``tests/test_fluid_full_model.py:235``): the
    port's int8 CRNN and its fp32 import agree on at least 95 % of the
    per-step argmaxes."""
    _, g32 = load_both("crnn_fluid")
    g8 = copy.deepcopy(g32)
    optimize(g8, quant=P.QuantConfig(), calib_batches=[_input(g8, 1)], device="cpu")
    feed = _input(g8, 4)
    a, b = _run_port(g8, feed)[g8.outputs[0]], _run_port(g32, feed)[g32.outputs[0]]
    assert (a.argmax(-1) == b.argmax(-1)).mean() > 0.95


def test_int8_op_on_a_float_activation_stays_on_torch():
    """The QAT SSD head's five later convs are int8 weights on fp32
    activations (their recorded scale goes with the relu folded into the
    conv before, in both packages): the kernel pick leaves them on
    ``"torch"``, which dequantizes the weight; every ``"cuda"`` op has an
    int8 activation (here only the NMS is one)."""
    from paddle_lite_tpu_torch.passes.kernel_pick import int8_activation

    _, gp = load_both("qat_ssd_head")
    optimize(gp, device="cpu")
    mixed = [op for op in gp.ops
             if op.attrs.get("enable_int8") and not int8_activation(gp, op)]
    assert len(mixed) == 5 and all(op.attrs.get("kernel") is None for op in mixed)
    assert [op.op_type for op in gp.ops if op.attrs.get("kernel") == "cuda"] == \
        ["multiclass_nms"]
