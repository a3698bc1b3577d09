"""PP-OCR det + rec (BASELINE config #4) through both packages.

DBNet at 64 px, batch 1, with its zoo config (``quant_depthwise=False``,
fp32 islands); CRNN at strip width 64, batch 2, 50 characters, with its zoo
config (bf16 islands) — the sizes of ``tests/test_model_zoo_int8.py:96,109``.
Inputs are made with numpy from a seed and handed to both packages.  Each
op the slice adds is also held alone against the reference's op.

Tolerances, and why:
- builds: the same ops and the same seeded weights, exactly;
- activation scales: rtol 1e-5 (abs-maxes of fp32 activations summed in
  another order by XLA and by torch); weights and weight scales exact;
- the reference's optimized graph run by both packages: int8 tensors at
  most 1 % of elements off, by at most 3 LSB (the SSD test's bound: an
  fp32 sum may round to the other side of a requant tie); under CRNN's
  bf16 islands, int8 tensors quantized from a recurrence's output (and
  after it) at most 3 LSB off in any share of elements: the two GRUs'
  bf16 carries differ by a few bf16 ulps (below), about 1 LSB at the
  recurrence's int8 scale, in about half the elements (measured ≤ 2 LSB in
  24 %);
- the same graph op by op, each port op fed the reference's captured
  inputs: int8, int32 and bf16 outputs equal, bit for bit, but
  ``bidirectional_gru``'s (held as below); fp32 outputs within rtol 1e-5,
  atol 1e-6 (fp32 sums in another order; measured one ulp);
- the DBNet probability map: atol 1e-5 (fp32 islands; a sigmoid of fp32
  logits, measured ≤ 2e-7);
- the CRNN probabilities under bf16 islands: atol 2^-7 = 0.0078 (a
  probability is rounded to bf16 between the softmax and the output, 2^-9
  relative, and the GRU carries differ by bf16 rounding; measured ≤ 5e-4);
- ``ctc_greedy_decode`` fed the reference's captured probabilities: exact;
- ``gru`` / ``bidirectional_gru``: fp32 atol 1e-6 (matmul sums in
  another order; measured 2.4e-7 at T = 40); bf16 atol 2^-5 = 0.03125
  (8 bf16 ulps of a carry near 1) and mean below 2^-8: the port rounds
  the carry to bf16 once a step and keeps the step in fp32, XLA's bf16
  sigmoid rounds inside (30 % of its outputs differ from the fp32 sigmoid
  rounded once), and a flipped carry ulp feeds every later step (measured
  max 0.0146, mean about 0.0016 at T = 16 and 40, hidden 48);
- ``nearest_interp`` exact (data movement; int8 passes through when the
  output var is int8); ``bilinear_interp`` atol 1e-6; ``pixel_shuffle``
  exact; ``conv2d_transpose`` rtol / atol 1e-5 (fp32 sums in another
  order);
- ``db_postprocess``: equal box for box; ``LengthBucketer``: the same
  buckets, padding and results as the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.executor import ExecutionContext as RContext
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.models import ppocr as r_ppocr
from paddle_lite_tpu.models.zoo_config import recommended_quant as r_quant
from paddle_lite_tpu.ops import extra as r_extra
from paddle_lite_tpu.ops import manip as r_manip
from paddle_lite_tpu.ops import nn as r_nn
from paddle_lite_tpu.ops import sequence as r_seq
from paddle_lite_tpu.tools import db_postprocess as r_db
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core.executor import ExecutionContext
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import ppocr as p_ppocr
from paddle_lite_tpu_torch.models.zoo_config import recommended_quant as p_quant
from paddle_lite_tpu_torch.ops.kernels import depthwise, int8_matmul
from paddle_lite_tpu_torch.tools import db_postprocess as p_db
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
SCALE_RTOL = 1e-5
INT8_FRACTION, INT8_LSB = 1e-2, 3
DET_ATOL = 1e-5
REC_PROB_ATOL = 2.0 ** -7
GRU_FP32_ATOL = 1e-6
GRU_BF16_ATOL, GRU_BF16_MEAN = 2.0 ** -5, 2.0 ** -8
INTERP_ATOL = 1e-6
DECONV_TOL = 1e-5

MODELS = {
    "det": dict(build="build_det", kw=dict(batch=1, image_size=64), shape=(1, 64, 64, 3),
                zoo="ppocr_det",
                # 10 int8 1x1 convs and 5 int8 3x3 convs on the GEMM
                cuda={"conv2d": 15}),
    "rec": dict(build="build_rec", kw=dict(batch=2, width=64, num_chars=50),
                shape=(2, 32, 64, 3), zoo="ppocr_rec",
                # 3 pointwise convs, 4 GRU input projections, the CTC classifier
                cuda={"conv2d": 3, "mul": 4, "fc": 1}),
}


def _feed(name, seed):
    return {"image": np.random.default_rng(seed).normal(size=MODELS[name]["shape"])
            .astype(np.float32)}


def _build(pkg, name):
    m = MODELS[name]
    return getattr(pkg, m["build"])(**m["kw"])


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    name = request.param
    calib = [_feed(name, 1)]
    gr = _build(r_ppocr, name)
    r_optimize(gr, quant=r_quant(MODELS[name]["zoo"]), calib_batches=calib)
    gp = _build(p_ppocr, name)
    optimize(gp, quant=p_quant(MODELS[name]["zoo"]), calib_batches=calib, device="cpu")
    return name, gr, gp


def _ref_capture(graph, feed):
    env = {}
    fn = R.build_callable(graph, platform="cpu", capture=lambda n, v: env.__setitem__(n, v))
    fn(R.stage_weights(graph), feed)
    return env


def _np(v):
    a = np.asarray(jax.device_get(v))
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_matches_reference(name):
    gr, gp = _build(r_ppocr, name), _build(p_ppocr, name)
    assert [o.op_type for o in gr.ops] == [o.op_type for o in gp.ops]
    for a, b in zip(gr.ops, gp.ops):
        assert a.inputs == b.inputs and a.outputs == b.outputs and a.attrs == b.attrs
    assert gr.inputs == gp.inputs and gr.outputs == gp.outputs
    assert {n: v.shape for n, v in gr.vars.items()} == {n: v.shape for n, v in gp.vars.items()}
    assert set(gr.weights) == set(gp.weights)
    for n, w in gr.weights.items():
        assert np.array_equal(np.asarray(w), gp.weights[n]), n


def test_optimize_matches_reference(pair):
    name, gr, gp = pair
    assert [o.op_type for o in gr.ops] == [o.op_type for o in gp.ops]
    for a, b in zip(gr.ops, gp.ops):
        assert a.inputs == b.inputs and a.outputs == b.outputs
        ka = {k: v for k, v in a.attrs.items() if k not in ("kernel", "out_scale")}
        kb = {k: v for k, v in b.attrs.items() if k not in ("kernel", "out_scale")}
        assert ka == kb, a.op_type
        assert ("out_scale" in a.attrs) == ("out_scale" in b.attrs)
        if "out_scale" in a.attrs:
            np.testing.assert_allclose(b.attrs["out_scale"], a.attrs["out_scale"],
                                       rtol=SCALE_RTOL)
    for n, v in gr.vars.items():
        w = gp.vars[n]
        assert v.precision.value == w.precision.value and v.shape == w.shape, n
        if v.quant is not None:
            np.testing.assert_allclose(w.quant.scale, v.quant.scale,
                                       rtol=0 if v.is_weight else SCALE_RTOL)
    for n, a in gr.weights.items():
        assert np.array_equal(np.asarray(a), gp.weights[n]), n
    assert gr.meta.get("island_dtype") == gp.meta.get("island_dtype") == (
        "bfloat16" if name == "rec" else None)
    tags = {}
    for o in gp.ops:
        if o.attrs.get("kernel") == "cuda":
            tags[o.op_type] = tags.get(o.op_type, 0) + 1
    assert tags == MODELS[name]["cuda"]
    if name == "det":  # deconv_pack rewrote both transposed convs
        types = [o.op_type for o in gp.ops]
        assert "conv2d_transpose" not in types and types.count("pixel_shuffle") == 1
        assert types.count("nearest_interp") == 6


def test_reference_graph_end_to_end(pair):
    """The reference's optimized graph (its meta, bf16 islands included,
    carried across) through both packages."""
    name, gr, _ = pair
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    assert gp.meta == gr.meta
    feed = _feed(name, 2)
    ref = _ref_capture(gr, feed)
    got = testing.capture_all(gp, P.stage_weights(gp, CPU), feed, CPU)
    after_gru, seen = set(), False
    for op in gr.topological_order():
        seen = seen or op.op_type == "bidirectional_gru"
        if seen:
            after_gru.update(n for ns in op.outputs.values() for n in ns)
    n_int8 = 0
    for n, r in ref.items():
        g = got[n]
        assert tuple(g.shape) == tuple(r.shape), n
        assert str(g.dtype).split(".")[-1] == str(r.dtype), n
        if r.dtype == jnp.int8:
            n_int8 += 1
            d = np.abs(g.numpy().astype(np.int32) - np.asarray(r).astype(np.int32))
            assert d.max() <= INT8_LSB, n
            assert n in after_gru or (d > 0).mean() <= INT8_FRACTION, n
    assert n_int8 >= (20 if name == "det" else 10)
    out = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)
    ref_out = R.build_callable(gr, platform="cpu")(R.stage_weights(gr), feed)
    for n in gr.outputs:
        assert out[n].dtype in (torch.float32, torch.int32), n
        if name == "det":
            np.testing.assert_allclose(out[n].numpy(), _np(ref_out[n]), rtol=0, atol=DET_ATOL)
        elif out[n].dtype == torch.float32:
            np.testing.assert_allclose(out[n].numpy(), _np(ref_out[n]), rtol=0,
                                       atol=REC_PROB_ATOL)


def _torch_of(v):
    a = np.asarray(jax.device_get(v))
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def test_op_by_op_on_reference_inputs(pair):
    """Each op of the reference's optimized graph, run by the port on the
    inputs the reference's run gave it, against the reference's output:
    equal bit for bit (an fp32 result compared after the executor's bf16
    rounding under islands), but bidirectional_gru's, within the GRU
    tolerance."""
    name, gr, _ = pair
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    env = _ref_capture(gr, _feed(name, 8))
    w = P.stage_weights(gp, CPU)
    ctx = ExecutionContext(graph=gp, device=CPU)
    island = torch.bfloat16 if gp.meta.get("island_dtype") == "bfloat16" else None
    n_ops = 0
    for op in gp.topological_order():
        ins = {s: [_torch_of(env[n]) if n in env else w[n] for n in ns]
               for s, ns in op.inputs.items() if ns}
        outs = OPS.get(op.op_type).impl_for(op.attrs.get("kernel"))(ctx, op, ins)
        for slot, arrs in outs.items():
            for n, a in zip(op.outputs[slot], arrs):
                if island is not None and a.dtype == torch.float32:
                    a = a.to(island)
                r = _torch_of(env[n])
                assert a.dtype == r.dtype and a.shape == r.shape, n
                d = (a.double() - r.double()).abs()
                if op.op_type == "bidirectional_gru":
                    assert float(d.max()) <= GRU_BF16_ATOL and float(d.mean()) <= GRU_BF16_MEAN
                elif a.dtype == torch.float32:
                    torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
                else:
                    assert float(d.max()) == 0.0, (op.op_type, n, float(d.max()))
        n_ops += 1
    assert n_ops == len(gr.ops)


def test_ctc_greedy_decode_on_captured_probs():
    gr = _build(r_ppocr, "rec")
    r_optimize(gr, quant=r_quant("ppocr_rec"), calib_batches=[_feed("rec", 1)])
    ref = _ref_capture(gr, _feed("rec", 3))
    op = next(o for o in gr.ops if o.op_type == "ctc_greedy_decode")
    probs = ref[op.input("X")]
    assert probs.dtype == jnp.bfloat16  # the island value the op reads
    want_out, want_len = ref[op.outputs["Out"][0]], ref[op.outputs["Length"][0]]
    x = torch.from_numpy(np.array(probs.astype(jnp.float32))).to(torch.bfloat16)
    got = OPS.get("ctc_greedy_decode").impls["torch"](None, op, {"X": [x]})
    assert got["Out"][0].dtype == torch.int32 and got["Length"][0].dtype == torch.int32
    np.testing.assert_array_equal(got["Out"][0].numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(got["Length"][0].numpy(), np.asarray(want_len))


class _Op:
    def __init__(self, op_type, attrs=None, inputs=None, outputs=None):
        self.op_type, self.attrs = op_type, attrs or {}
        self.inputs, self.outputs = inputs or {}, outputs or {}

    def input(self, slot):
        return self.inputs[slot][0]

    def output(self, slot):
        return self.outputs[slot][0]


def test_ctc_greedy_decode_ties_take_the_first_class():
    """Ties are common among bf16 probabilities: both take the first maximal
    class; repeats collapse, blanks drop, the tail is -1."""
    p = np.zeros((2, 7, 4), np.float32)
    ids = [[1, 1, 3, 2, 2, 3, 1], [3, 3, 3, 0, 0, 0, 3]]
    for b in range(2):
        for t, c in enumerate(ids[b]):
            p[b, t, c] = 0.5
    p[0, 3, 0] = 0.5  # a tie: class 0 comes first
    op = _Op("ctc_greedy_decode")
    want = r_seq.ctc_greedy_decode_xla(None, op, {"X": [jnp.asarray(p, jnp.bfloat16)]})
    got = OPS.get("ctc_greedy_decode").impls["torch"](
        None, op, {"X": [torch.from_numpy(p).to(torch.bfloat16)]})
    for slot in ("Out", "Length"):
        np.testing.assert_array_equal(got[slot][0].numpy(), np.asarray(want[slot][0]))
    np.testing.assert_array_equal(got["Out"][0].numpy()[0], [1, 0, 2, 1, -1, -1, -1])


def _gru_inputs(rng, b, t, h, bidirectional):
    f = np.float32
    ins = {"Input": rng.normal(size=(b, t, 3 * h)).astype(f),
           ("WeightFw" if bidirectional else "Weight"):
               (rng.normal(size=(h, 3 * h)) / np.sqrt(h)).astype(f),
           ("BiasFw" if bidirectional else "Bias"): (0.1 * rng.normal(size=3 * h)).astype(f)}
    if bidirectional:
        ins.update(InputRev=rng.normal(size=(b, t, 3 * h)).astype(f),
                   WeightBw=(rng.normal(size=(h, 3 * h)) / np.sqrt(h)).astype(f),
                   BiasBw=(0.1 * rng.normal(size=3 * h)).astype(f))
    return ins


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["bigru", "gru", "gru_reverse", "gru_h0",
                                  "gru_reverse_h0"])
def test_gru_ops_match_reference(case, dtype):
    rng = np.random.default_rng(len(case))
    b, t, h = 3, 40, 48
    ins = _gru_inputs(rng, b, t, h, case == "bigru")
    attrs = {"is_reverse": "reverse" in case}
    if "h0" in case:
        ins["H0"] = (0.5 * rng.normal(size=(b, h))).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ins_r = {k: [jnp.asarray(v, jdt)] for k, v in ins.items()}
    ins_p = {k: [torch.from_numpy(v).to(tdt)] for k, v in ins.items()}
    op_type = "bidirectional_gru" if case == "bigru" else "gru"
    r_impl = r_seq.bigru_xla if case == "bigru" else r_seq.gru_xla
    want = r_impl(None, _Op(op_type, attrs), ins_r)["Hidden"][0]
    got = OPS.get(op_type).impls["torch"](None, _Op(op_type, attrs), ins_p)["Hidden"][0]
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    d = np.abs(got.float().numpy() - _np(want))
    if dtype == "float32":
        assert d.max() <= GRU_FP32_ATOL
    else:
        assert d.max() <= GRU_BF16_ATOL and d.mean() <= GRU_BF16_MEAN


def _interp_ctx(op_type, x, out_shape, out_int8=False, scale=0.05):
    """A one-op graph for each package: interp of `x` to `out_shape`."""
    from paddle_lite_tpu.core.ir import Graph as RGraph
    from paddle_lite_tpu.core.types import Precision as RPrecision
    from paddle_lite_tpu.core.types import QuantInfo as RQuant

    g = RGraph("t")
    prec = RPrecision.INT8 if x.dtype == np.int8 else RPrecision.FP32
    g.add_var("x", x.shape, precision=prec)
    if x.dtype == np.int8:
        g.vars["x"].quant = RQuant.per_tensor(scale)
    g.inputs.append("x")
    g.add_var("y", out_shape, precision=RPrecision.INT8 if out_int8 else RPrecision.FP32)
    g.outputs.append("y")
    g.add_op(op_type, {"X": ["x"]}, {"Out": ["y"]},
             {"out_h": out_shape[1], "out_w": out_shape[2]})
    g.rebuild_links()
    return g


@pytest.mark.parametrize("op_type,src,dst,int8_in,int8_out", [
    ("nearest_interp", (2, 4, 5, 3), (2, 8, 10, 3), True, True),     # int8 copy
    ("nearest_interp", (2, 4, 5, 3), (2, 16, 20, 3), True, False),   # dequantized
    ("nearest_interp", (2, 4, 5, 3), (2, 32, 40, 3), False, False),  # broadcast x8
    ("nearest_interp", (2, 6, 5, 3), (2, 9, 13, 3), False, False),   # gather
    ("nearest_interp", (1, 9, 13, 2), (1, 4, 5, 2), False, False),   # down
    ("nearest_interp", (1, 3, 3, 2), (1, 6, 6, 2), False, False),
    ("bilinear_interp", (2, 4, 5, 3), (2, 8, 10, 3), False, False),
    ("bilinear_interp", (2, 6, 5, 3), (2, 9, 13, 3), False, False),
    ("bilinear_interp", (1, 9, 13, 2), (1, 4, 5, 2), False, False),  # antialiased down
    ("bilinear_interp", (1, 5, 7, 2), (1, 11, 3, 2), False, False),  # up and down
])
def test_interp_matches_reference(op_type, src, dst, int8_in, int8_out):
    rng = np.random.default_rng(sum(src) + sum(dst))
    x = (rng.integers(-127, 128, size=src, dtype=np.int8) if int8_in
         else rng.normal(size=src).astype(np.float32))
    gr = _interp_ctx(op_type, x, dst, out_int8=int8_out)
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    want = _np(R.build_callable(gr, platform="cpu")({}, {"x": x})["y"])
    got = P.build_callable(gp, device=CPU)({}, {"x": x})["y"].numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if op_type.startswith("nearest"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=INTERP_ATOL)


def test_bilinear_align_corners_matches_reference():
    x = np.random.default_rng(5).normal(size=(2, 4, 6, 3)).astype(np.float32)
    op = _Op("bilinear_interp", {"align_corners": True}, {"X": ["x"]}, {"Out": ["y"]})
    gr = _interp_ctx("bilinear_interp", x, (2, 7, 11, 3))
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    want = r_manip.interp_xla(RContext(graph=gr, platform="cpu"), op,
                              {"X": [jnp.asarray(x)]})["Out"][0]
    got = OPS.get("bilinear_interp").impls["torch"](
        ExecutionContext(graph=gp, device=CPU), op, {"X": [torch.from_numpy(x)]})["Out"][0]
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=INTERP_ATOL)


@pytest.mark.parametrize("r,dtype", [(2, np.float32), (4, np.int8), (2, np.int8)])
def test_pixel_shuffle_matches_reference(r, dtype):
    rng = np.random.default_rng(r)
    x = rng.normal(size=(2, 3, 5, 3 * r * r)).astype(np.float32)
    if dtype == np.int8:
        x = rng.integers(-127, 128, size=x.shape, dtype=np.int8)
    op = _Op("pixel_shuffle", {"upscale_factor": r})
    want = r_extra.pixel_shuffle_xla(None, op, {"X": [jnp.asarray(x)]})["Out"][0]
    got = OPS.get("pixel_shuffle").impls["torch"](None, op, {"X": [torch.from_numpy(x)]})
    np.testing.assert_array_equal(got["Out"][0].numpy(), np.asarray(want))


@pytest.mark.parametrize("k,s,pads,out_pad,dil,bias", [
    (2, 2, [0, 0], [0, 0], 1, False),  # the one-GEMM form (kernel == stride)
    (2, 2, [0, 0], [0, 0], 1, True),
    (3, 2, [1, 1], [1, 1], 1, True),   # the general form
    (4, 2, [1, 1], [0, 0], 1, False),
    (3, 1, [0, 0], [0, 0], 2, True),
    (3, 3, [2, 1], [0, 0], 1, False),
])
def test_conv2d_transpose_matches_reference(k, s, pads, out_pad, dil, bias):
    from paddle_lite_tpu.core.ir import Graph as RGraph

    rng = np.random.default_rng(k * 10 + s)
    x = rng.normal(size=(2, 5, 6, 8)).astype(np.float32)
    g = RGraph("t")
    g.add_var("x", x.shape)
    g.inputs.append("x")
    g.add_weight("w", rng.normal(size=(k, k, 8, 4)).astype(np.float32))
    ins = {"Input": ["x"], "Filter": ["w"]}
    if bias:
        g.add_weight("b", rng.normal(size=(4,)).astype(np.float32))
        ins["Bias"] = ["b"]
    attrs = {"strides": [s, s], "paddings": pads, "output_padding": out_pad,
             "dilations": [dil, dil]}
    (shape,) = r_nn.conv2d_transpose_shape(attrs, [x.shape, (k, k, 8, 4)])
    g.add_var("y", shape)
    g.outputs.append("y")
    g.add_op("conv2d_transpose", ins, {"Output": ["y"]}, attrs)
    g.rebuild_links()
    gp = graph_from_reference(artifact.graph_to_meta(g), g.weights)
    want = _np(R.build_callable(g, platform="cpu")(R.stage_weights(g), {"x": x})["y"])
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), {"x": x})["y"]
    assert tuple(got.shape) == want.shape == tuple(shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=DECONV_TOL, atol=DECONV_TOL)


def test_unoptimized_det_graph_matches_reference():
    """The fp32 DBNet graph before ``deconv_pack``: both conv2d_transposes,
    batch_norm, nearest_interp and sigmoid on the torch path."""
    gr, gp = _build(r_ppocr, "det"), _build(p_ppocr, "det")
    assert [o.op_type for o in gp.ops].count("conv2d_transpose") == 2
    feed = _feed("det", 4)
    want = _np(R.build_callable(gr, platform="cpu")(R.stage_weights(gr), feed)[gr.outputs[0]])
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)[gp.outputs[0]]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DET_ATOL)


def test_db_postprocess_matches_reference():
    rng = np.random.default_rng(6)
    p = (0.25 * rng.random((48, 64))).astype(np.float32)
    p[5:15, 10:30] = 0.9
    p[25:35, 40:55] = 0.8
    p[20:22, 2:4] = 0.9  # below min_size
    p[40:44, 5:25] = 0.45  # below box_thresh
    for kw in ({}, {"min_size": 1}, {"box_thresh": 0.4, "unclip_ratio": 2.0}):
        want = r_db.extract_boxes(p, **kw)
        got = p_db.extract_boxes(p[..., None], **kw)
        assert [vars(b) for b in got] == [vars(b) for b in want]
    assert len(p_db.extract_boxes(p)) == 2
    assert p_db.extract_boxes(np.zeros((10, 10), np.float32)) == []


def test_length_bucketer_routes_as_the_reference():
    from paddle_lite_tpu.runtime.batcher import BatcherConfig as RConfig
    from paddle_lite_tpu.runtime.length_bucketer import LengthBucketer as RBucketer
    from paddle_lite_tpu_torch.runtime.batcher import BatcherConfig
    from paddle_lite_tpu_torch.runtime.length_bucketer import LengthBucketer

    class Echo:
        def __init__(self, batch, length):
            self.batch, self.length = batch, length

        def run(self, inputs):
            x = inputs["image"]
            assert x.shape == (self.batch, 2, self.length)
            return {"sum": x.sum(axis=(1, 2)), "width": np.full((self.batch,), self.length)}

    results = []
    for bucketer, config in ((RBucketer, RConfig), (LengthBucketer, BatcherConfig)):
        built = []
        lb = bucketer(lambda b, n: built.append((b, n)) or Echo(b, n),
                      length_buckets=(64, 16, 32), seq_axes={"image": 1},
                      batcher_config=config(buckets=(1, 2, 4), max_wait_ms=20.0))
        try:
            futs = [lb.submit({"image": np.full((2, n), float(n), np.float32)})
                    for n in (10, 16, 20, 50, 64)]
            out = [(float(f.result(10)["sum"]), int(f.result(10)["width"])) for f in futs]
            with pytest.raises(ValueError, match="exceeds"):
                lb.submit({"image": np.ones((2, 65), np.float32)})
        finally:
            lb.close()
        results.append((out, sorted({n for _, n in built}), dict(lb.stats),
                        lb.length_buckets))
    assert results[0] == results[1]
    assert results[1][0][0] == (200.0, 16) and results[1][2]["padded_tokens"] == 6 + 12 + 14


@pytest.mark.parametrize("name", sorted(MODELS))
def test_predictor_serves_on_cpu(name):
    """create_predictor with the zoo config: no kernel launches on the CPU
    (the wrappers take their plain versions), fp32 public outputs."""
    from paddle_lite_tpu_torch.runtime.predictor import create_predictor

    g = _build(p_ppocr, name)
    pred = create_predictor(g, quant=p_quant(MODELS[name]["zoo"]),
                            calib_batches=[_feed(name, 1)], device="cpu")
    int8_matmul.launches = depthwise.launches = 0
    out = pred.run(_feed(name, 5))
    assert (int8_matmul.launches, depthwise.launches) == (0, 0)
    if name == "det":
        y = out[g.outputs[0]]
        assert y.shape == (1, 64, 64, 1) and y.dtype == torch.float32
        assert bool(((y >= 0) & (y <= 1)).all())
    else:
        probs, dec = out[g.outputs[0]], out[g.outputs[1]]
        assert probs.dtype == torch.float32 and probs.shape == (2, 16, 51)
        np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=0.02)
        assert dec.dtype == torch.int32 and dec.shape == (2, 16)
        assert bool(((dec >= -1) & (dec < 50)).all())


def test_compiled_rec_equals_eager_on_cpu():
    """compile_graph on the island graph (the eager loop on static fp32
    input buffers on the CPU) gives the eager loop's outputs."""
    g = _build(p_ppocr, "rec")
    optimize(g, quant=p_quant("ppocr_rec"), calib_batches=[_feed("rec", 1)], device="cpu")
    fn, w = P.compile_graph(g, device=CPU)
    assert fn._inputs["image"].dtype == torch.float32
    feed = _feed("rec", 7)
    a = fn(w, feed)
    b = P.build_callable(g, device=CPU)(w, feed)
    for n in g.outputs:
        assert torch.equal(a[n], b[n]), n
