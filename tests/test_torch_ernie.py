"""ERNIE-tiny (BASELINE config #5) through both packages.

The model at the JAX test's size (``tests/test_model_zoo_int8.py``: batch
2, 16 tokens, vocabulary 500, hidden 64, 2 layers, 4 heads, FFN 128, seed
7), optimized under the default ``QuantConfig``, the JAX package's zoo
config (``recommended_quant("ernie_tiny")`` there: bf16 islands, tanh-gelu;
the port's own table, measured on the card, ships the defaults) and with
int8 act×act attention matmuls.  Token and segment ids are made with numpy
from a seed and handed to both packages.  Each op the slice adds is held
alone against the reference's op, and the GEMM's epilogue with gelu and
tanh against the Pallas kernel in interpret mode.

Tolerances, and why:
- ``lookup_table``, ``transpose``, ``split``, ``slice``: exact (data
  movement; NaN rows where the reference's fill mode gives them);
- ``layer_norm`` (fp32 and bf16 input) and the float ``matmul``: rtol and
  atol 1e-5 (fp32 sums in another order; measured a few ulps);
- the int8 act×act ``matmul``: int8 outputs bit-equal, fp32 outputs within
  1 ulp (the accumulator is exact in both packages, and the scaling is the
  same fp32 arithmetic; measured equal);
- the GEMM's plain version with gelu or tanh against the Pallas kernel:
  fp32 outputs within rtol 2e-6, atol 1e-6, int8 outputs within
  ``testing.within_tie_bound`` (at most 1 LSB, in at most 1e-4 of the
  elements or 2): XLA's tanh / erfc and PyTorch's differ by a few ulps,
  which moves a requant tie (measured 1 of 16,384 elements, 1 LSB);
- optimize(): the same ops and attrs, activation scales within rtol 1e-5
  (abs-maxes summed in another order), weights and weight scales exact;
- the reference's optimized graph op by op, each port op fed the
  reference's captured inputs: int8 tensors bit-equal but the outputs of
  ops with a fused gelu or tanh, held to ``testing.within_tie_bound``;
  fp32 tensors within rtol / atol 1e-5; bf16 tensors within one bf16 ulp
  (a float sum in another order may round to the neighbouring bf16;
  measured in 2 of 2,048 elements of one layer_norm, bf16 islands);
- the probabilities end to end: fp32 within 1e-5; int8, the reference's
  optimized graph run by the port, within ``testing.SOFTMAX_ATOL`` = 1e-3
  (a tie flipped by 1 LSB after a gelu moves a 2-class probability by
  about 1e-4; measured 0); int8, each package optimizing its own graph,
  within 0.02: the independently calibrated scales differ in their last
  bits, so any requant may meet a tie (measured 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.builder import GraphBuilder as RBuilder
from paddle_lite_tpu.core.executor import ExecutionContext as RContext
from paddle_lite_tpu.core.registry import OPS as ROPS
from paddle_lite_tpu.core.types import Precision as RPrecision
from paddle_lite_tpu.core.types import QuantInfo as RQuant
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.models import ernie_tiny as r_ernie
from paddle_lite_tpu.models.zoo_config import RECOMMENDED as R_RECOMMENDED
from paddle_lite_tpu.models.zoo_config import recommended_quant as r_quant
from paddle_lite_tpu.ops.kernels.int8_matmul import int8_matmul as r_int8_matmul
from paddle_lite_tpu.quant.quantize_pass import QuantConfig as RQuantConfig
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core.executor import ExecutionContext
from paddle_lite_tpu_torch.core.ir import Graph
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import ernie_tiny as p_ernie
from paddle_lite_tpu_torch.ops.kernels import depthwise, dw_pw_fused
from paddle_lite_tpu_torch.ops.kernels import int8_matmul as km
from paddle_lite_tpu_torch.ops.kernels.select import choose_kernel
from paddle_lite_tpu_torch.quant.quantize_pass import QuantConfig
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
KW = dict(batch=2, seq_len=16, vocab_size=500, hidden=64, n_layers=2, n_heads=4,
          ffn_dim=128, seed=7)
OP_TOL = 1e-5
GEMM_RTOL, GEMM_ATOL = 2e-6, 1e-6
SCALE_RTOL = 1e-5
FP32_PROB_ATOL = 1e-5
OWN_GRAPHS_PROB_ATOL = 0.02
BF16_ULP = 2.0 ** -7  # a bf16 ulp is at most this fraction of the value

CONFIGS = {
    "default": (RQuantConfig, QuantConfig, {}),
    # the reference's zoo entry (bf16 islands) in both packages; the port's
    # own table, measured on the card, ships the defaults
    "zoo": (lambda: r_quant("ernie_tiny"), lambda: QuantConfig(**R_RECOMMENDED["ernie_tiny"]),
            None),
    "act_act": (RQuantConfig, QuantConfig, {"quant_act_act_matmul": True}),
}


def _quant(name, pkg):
    r, p, kw = CONFIGS[name]
    make = r if pkg == "r" else p
    return make() if kw is None else make(**kw)


def _feed(seed, batch=KW["batch"], seq=KW["seq_len"]):
    rng = np.random.default_rng(seed)
    return {"token_ids": rng.integers(0, KW["vocab_size"], (batch, seq)).astype(np.int32),
            "segment_ids": rng.integers(0, 4, (batch, seq)).astype(np.int32)}


def _np(v):
    a = np.asarray(jax.device_get(v))
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _torch_of(v):
    a = np.asarray(jax.device_get(v))
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ---- each new op against the reference's op ---------------------------------

def _one_op(op_type, arrays, attrs, *, out_slots=("Out",), quant=None, bf16=False):
    """Run `op_type` once in each package on the same inputs: a one-op
    graph built with the reference's builder (``arrays``: slot -> numpy
    arrays, the graph's inputs; ``quant``: input name -> QuantInfo),
    carried across with ``graph_from_reference``; each package's impl is
    called on the inputs directly (float inputs as bf16 with ``bf16``).
    Returns (reference outputs, port outputs), slot -> arrays."""
    b = RBuilder("t")
    inputs = {}
    prec = {np.dtype(np.int8): RPrecision.INT8, np.dtype(np.int32): RPrecision.INT32,
            np.dtype(np.int64): RPrecision.INT64, np.dtype(np.float32): RPrecision.FP32}
    for slot, arrs in arrays.items():
        inputs[slot] = [b.input(f"{slot}{i}", a.shape, precision=prec[a.dtype])
                        for i, a in enumerate(arrs)]
    b.op(op_type, inputs, attrs=attrs, out_slots=out_slots)
    gr = b.build()
    for name, q in (quant or {}).items():
        gr.vars[name].quant = q
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    rop, pop = gr.ops[0], gp.ops[0]

    def r_arr(a):
        return jnp.asarray(a, jnp.bfloat16) if bf16 and a.dtype == np.float32 else jnp.asarray(a)

    def p_arr(a):
        t = torch.from_numpy(np.array(a))
        return t.to(torch.bfloat16) if bf16 and a.dtype == np.float32 else t

    want = ROPS.get(op_type).impls["xla"](
        RContext(graph=gr, platform="cpu"), rop,
        {s: [r_arr(a) for a in arrs] for s, arrs in arrays.items()})
    got = OPS.get(op_type).impls["torch"](
        ExecutionContext(graph=gp, device=CPU), pop,
        {s: [p_arr(a) for a in arrs] for s, arrs in arrays.items()})
    assert set(want) == set(got)
    return want, got


def _assert_equal(want, got):
    for slot in want:
        assert len(want[slot]) == len(got[slot]), slot
        for w, g in zip(want[slot], got[slot]):
            w = np.asarray(jax.device_get(w))
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype, w.dtype)
            assert tuple(g.shape) == w.shape
            g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
            np.testing.assert_array_equal(g, _np(w))


@pytest.mark.parametrize("op_type", ["lookup_table", "lookup_table_v2"])
@pytest.mark.parametrize("trailing", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_lookup_table_matches_reference(op_type, trailing, bf16):
    """``jnp.take``'s fill mode: ids at or past V give NaN rows, ids in
    [-V, 0) count from the end, ids below -V give NaN; a trailing dim of 1
    is squeezed."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(7, 5)).astype(np.float32)
    ids = np.array([[0, 6, 7, 100, -1, -7, -8, 3], [2, 2, 5, -3, 1, 9, 0, -100]], np.int32)
    if trailing:
        ids = ids[..., None]
    want, got = _one_op(op_type, {"W": [w], "Ids": [ids]}, {}, bf16=bf16)
    _assert_equal(want, got)
    out = got["Out"][0].float().numpy()
    assert out.shape == (2, 8, 5)
    nan_rows = np.isnan(out).all(axis=-1)
    assert nan_rows.sum() == 5 and not np.isnan(out[~nan_rows]).any()
    np.testing.assert_array_equal(out[0, 4], out[0, 1])  # -1 is row 6


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_lookup_table_integer_table_fill(dtype):
    """An integer table's fill is its dtype's minimum, as jnp.take's."""
    w = np.arange(-10, 11, dtype=dtype).reshape(7, 3)
    ids = np.array([[0, 7, -8, -1, 3]], np.int32)
    want, got = _one_op("lookup_table", {"W": [w], "Ids": [ids]}, {})
    _assert_equal(want, got)
    assert (got["Out"][0].numpy()[0, 1:3] == np.iinfo(dtype).min).all()


@pytest.mark.parametrize("op_type", ["transpose", "transpose2"])
@pytest.mark.parametrize("perm,dtype", [((0, 2, 1, 3), np.float32), ((3, 1, 0, 2), np.float32),
                                        ((0, 2, 1, 3), np.int8)])
def test_transpose_matches_reference(op_type, perm, dtype):
    rng = np.random.default_rng(4)
    x = (rng.integers(-127, 128, (2, 3, 4, 5)).astype(np.int8) if dtype == np.int8
         else rng.normal(size=(2, 3, 4, 5)).astype(np.float32))
    _assert_equal(*_one_op(op_type, {"X": [x]}, {"axis": list(perm)}))


@pytest.mark.parametrize("attrs", [{"axis": 2, "num": 3}, {"axis": 2, "sections": [1, 2, 3]},
                                   {"axis": -1, "sections": [4, 2]}, {"axis": 0, "num": 2}])
def test_split_matches_reference(attrs):
    x = np.random.default_rng(5).normal(size=(2, 4, 6)).astype(np.float32)
    want, got = _one_op("split", {"X": [x]}, attrs)
    assert len(got["Out"]) == attrs.get("num") or len(attrs.get("sections", ()))
    _assert_equal(want, got)


@pytest.mark.parametrize("attrs", [
    {"axes": [1], "starts": [0], "ends": [1], "decrease_axis": [1]},   # ERNIE's [CLS]
    {"axes": [1], "starts": [-3], "ends": [-1]},                       # negative bounds
    {"axes": [2], "starts": [2], "ends": [100]},                       # clamped end
    {"axes": [0, 2], "starts": [-1, -100], "ends": [5, 3], "decrease_axis": [0]},
    {"axes": [1], "starts": [3], "ends": [2]},                         # empty
])
def test_slice_matches_reference(attrs):
    x = np.random.default_rng(6).normal(size=(2, 5, 6)).astype(np.float32)
    _assert_equal(*_one_op("slice", {"X": [x]}, attrs))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("begin,eps,affine", [(2, 1e-12, True), (2, 1e-5, True),
                                              (1, 1e-5, False)])
def test_layer_norm_matches_reference(bf16, begin, eps, affine):
    rng = np.random.default_rng(7)
    arrays = {"X": [(3 * rng.normal(size=(2, 16, 64)) + 1).astype(np.float32)]}
    if affine:
        arrays["Scale"] = [rng.normal(1, 0.2, 64).astype(np.float32)]
        arrays["Bias"] = [rng.normal(0, 0.2, 64).astype(np.float32)]
    want, got = _one_op("layer_norm", arrays, {"begin_norm_axis": begin, "epsilon": eps},
                        out_slots=("Y",), bf16=bf16)
    g, w = got["Y"][0], _np(want["Y"][0])
    assert g.dtype == torch.float32 and str(want["Y"][0].dtype) == "float32"
    np.testing.assert_allclose(g.numpy(), w, rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("xs,ys,attrs", [
    ((2, 4, 8, 16), (2, 4, 16, 8), {}),
    ((2, 4, 8, 16), (2, 4, 8, 16), {"transpose_Y": True, "alpha": 0.25}),
    ((2, 4, 16, 8), (2, 4, 16, 8), {"transpose_X": True}),
    ((2, 4, 8, 16), (16, 8), {"alpha": 0.5, "fuse_act": "relu"}),       # Y broadcast
    ((8, 16), (3, 16, 8), {"fuse_act": "gelu", "act_attrs": {"approximate": True}}),
])
@pytest.mark.parametrize("bf16", [False, True])
def test_float_matmul_matches_reference(xs, ys, attrs, bf16):
    rng = np.random.default_rng(len(xs) + len(ys))
    x, y = (rng.normal(size=s).astype(np.float32) for s in (xs, ys))
    want, got = _one_op("matmul", {"X": [x], "Y": [y]}, attrs, bf16=bf16)
    g, w = got["Out"][0], _np(want["Out"][0])
    assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
    np.testing.assert_allclose(g.numpy(), w, rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("case", ["qk", "pv_out_scale", "per_channel_y", "k_past_exact",
                                  "gelu_out_scale"])
def test_int8_matmul_matches_reference(case):
    """The act×act path: an exact int32 accumulator (past K = 1040 too,
    where one fp32 matmul would round: every operand ±127 at K = 1200),
    scaled by s_x·s_y (per channel on Y), alpha, act, requant."""
    rng = np.random.default_rng(len(case))
    xs, ys = (2, 4, 16, 16), (2, 4, 16, 16)
    attrs, q_y = {"transpose_Y": True, "alpha": 0.25}, RQuant.per_tensor(0.031)
    if case == "pv_out_scale":
        attrs = {"out_scale": 0.05}
    elif case == "per_channel_y":
        attrs = {}
        q_y = RQuant.per_channel_scales(rng.uniform(0.01, 0.03, 16), axis=3)
    elif case == "k_past_exact":
        xs, ys, attrs = (2, 3, 1301), (2, 1301, 5), {}
    elif case == "gelu_out_scale":
        attrs = {"fuse_act": "gelu", "act_attrs": {"approximate": True}, "out_scale": 0.3}
    x = rng.integers(-127, 128, xs).astype(np.int8)
    y = rng.integers(-127, 128, ys).astype(np.int8)
    if case == "k_past_exact":  # sums of 1,300 odd products: odd, past 2^24
        x, y = np.full(xs, 127, np.int8), np.full(ys, 127, np.int8)
        y[:, rng.integers(0, ys[1], ys[2]), np.arange(ys[2])] = -127
    quant = {"X0": RQuant.per_tensor(0.017), "Y0": q_y}
    want, got = _one_op("matmul", {"X": [x], "Y": [y]}, attrs, quant=quant)
    g, w = got["Out"][0], np.asarray(want["Out"][0])
    assert str(g.dtype).split(".")[-1] == str(w.dtype) and tuple(g.shape) == w.shape
    if w.dtype == np.int8:
        np.testing.assert_array_equal(g.numpy(), w)
    else:
        np.testing.assert_array_max_ulp(g.numpy(), w, maxulp=1)
    if case == "k_past_exact":
        exact = x.astype(np.int64) @ y.astype(np.int64) * np.int64(1)
        assert exact.min() > 2 ** 24 and (exact % 2).all()
        np.testing.assert_array_equal(
            g.numpy(), exact.astype(np.float32) * np.float32(np.float32(0.017) * np.float32(0.031)))


def test_gelu_is_jax_nn_gelu_operation_for_operation():
    """Both forms, and tanh, against jax.nn.gelu / jnp.tanh on the same fp32
    values (the transcendental functions of XLA and PyTorch differ by a
    few ulps; everything around them is the same arithmetic)."""
    from paddle_lite_tpu_torch.ops.common import apply_activation

    x = np.random.default_rng(8).normal(0, 3, 20000).astype(np.float32)
    for act, attrs, ref in (("gelu", {"approximate": True}, jax.nn.gelu(x, approximate=True)),
                            ("gelu", {}, jax.nn.gelu(x, approximate=False)),
                            ("tanh", None, jnp.tanh(x))):
        got = apply_activation(torch.from_numpy(x), act, attrs).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=GEMM_RTOL, atol=GEMM_ATOL)


# ---- the GEMM's epilogue: gelu and tanh ---------------------------------------

@pytest.mark.parametrize("act,attrs,code", [("gelu", {"approximate": True}, 6),
                                            ("gelu", {"approximate": False}, 7),
                                            ("gelu", {}, 7), ("tanh", None, 8)])
@pytest.mark.parametrize("int8_out", [True, False])
@pytest.mark.parametrize("mkn", [(64, 128, 256), (100, 256, 72)])
def test_gemm_plain_with_gelu_tanh_matches_pallas(act, attrs, code, int8_out, mkn):
    """The GEMM's plain version (the CPU route and the card's yardstick)
    against the Pallas kernel in interpret mode, as the JAX suite runs it;
    the C code and its parameters are jax.nn.gelu's constants in fp32."""
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    eff = rng.uniform(1e-4, 2e-4, n).astype(np.float32)
    bias = rng.normal(0, 0.5, n).astype(np.float32)
    out_scale = 0.02 if int8_out else None
    want = np.asarray(r_int8_matmul(x, w, eff, bias, act=act, act_attrs=attrs,
                                    out_scale=out_scale, interpret=True))
    got = km.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(eff),
                         torch.from_numpy(bias), act=act, act_attrs=attrs,
                         out_scale=out_scale).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if int8_out:
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert testing.within_tie_bound([{"numel": d.size, "n_diff": int((d > 0).sum()),
                                          "max_diff": float(d.max())}])
    else:
        np.testing.assert_allclose(got, want, rtol=GEMM_RTOL, atol=GEMM_ATOL)
    args = km.act_args(act, attrs, km.GEMM_ACTS)
    assert args[0] == code
    consts = {6: (np.sqrt(2 / np.pi), 0.044715, 0.0), 7: (np.sqrt(0.5), 0.0, 0.0),
              8: (0.0, 0.0, 0.0)}[code]
    assert args[1:] == tuple(float(np.float32(c)) for c in consts)


FULL = dict(batch=32, seq_len=128)  # BASELINE's ERNIE-tiny, the benchmark's default
# the GEMM shapes of one request at b32 / len 128 (M = 4,096 tokens), each
# with its launches a request, output and activation
FULL_SHAPES = {(4096, 1024, 3072): (3, "fp32", None),      # QKV
               (4096, 1024, 1024): (3, "fp32", None),      # output projection
               (4096, 1024, 4096): (3, "int8", "gelu"),    # FFN1
               (4096, 4096, 1024): (3, "fp32", None),      # FFN2
               (32, 1024, 1024): (1, "int8", "tanh"),      # pooler
               (32, 1024, 2): (1, "fp32", None)}           # classifier


def test_gemm_plan_at_full_size():
    """The 14 GEMM launches of a b32 / len 128 request, read off the
    full-size graph after the fusion passes (parallel_fc_fuse's QKV fc),
    and the kernel's plan at each: what ``csrc/int8_gemm.cu`` needs."""
    g = p_ernie.build(**FULL)
    optimize(g, device="cpu")
    shapes = {}
    for op in g.topological_order():
        if op.op_type != "fc":
            continue
        x = g.vars[op.input("Input")].shape
        ncd = int(op.attrs.get("in_num_col_dims", len(x) - 1))
        key = (int(np.prod(x[:ncd])),) + tuple(g.vars[op.input("W")].shape)
        shapes.setdefault(key, []).append(op.attrs.get("fuse_act"))
    assert {k: len(v) for k, v in shapes.items()} == {k: v[0] for k, v in FULL_SHAPES.items()}
    assert {k: v[0] for k, v in shapes.items()} == {k: v[2] for k, v in FULL_SHAPES.items()}
    for (m, k, n), (_, out, _) in FULL_SHAPES.items():
        out_i8 = out == "int8"
        p = km.plan(m, k, n, out_i8)
        bm, es = 64 * p.warpgroups, 1 if out_i8 else 4
        assert p.smem_bytes == km.smem_bytes(bm, p.bn, p.bk, out_i8) <= km.SMEM_LIMIT
        assert p.tiles == -(-m // bm) * -(-n // p.bn)
        assert k % p.width == 0 and p.bk % p.width == 0 and p.width == 16
        assert (n * es) % p.out_width == 0 and (p.bn * es) % p.out_width == 0


# ---- routing -------------------------------------------------------------------

@pytest.mark.parametrize("act,attrs", [("gelu", {"approximate": True}), ("gelu", {}),
                                       ("tanh", None)])
def test_gelu_tanh_route_to_the_gemm_only(act, attrs):
    """An int8 fc / conv2d with gelu or tanh takes the GEMM; a depthwise
    conv and a fused dw+pw block with one stay on "torch", and their
    kernels' wrappers raise for the codes (their epilogue lacks them)."""
    g = Graph("t")
    g.add_var("x", (1, 4, 4, 8))
    g.add_weight("w", np.zeros((1, 1, 8, 8), np.int8))
    g.add_weight("dw", np.zeros((3, 3, 1, 8), np.int8))
    g.add_weight("fw", np.zeros((8, 8), np.int8))
    for n in ("y", "z", "f"):
        g.add_var(n, (1, 4, 4, 8))
    a = {"enable_int8": True, "strides": [1, 1], "paddings": [0, 0], "fuse_act": act}
    if attrs is not None:
        a["act_attrs"] = attrs
    pw = g.add_op("conv2d", {"Input": ["x"], "Filter": ["w"]}, {"Output": ["y"]}, a)
    dw = g.add_op("depthwise_conv2d", {"Input": ["y"], "Filter": ["dw"]},
                  {"Output": ["z"]}, dict(a, paddings=[1, 1]))
    fc = g.add_op("fc", {"Input": ["z"], "W": ["fw"]}, {"Out": ["f"]}, a)
    assert choose_kernel(g, pw) == "cuda" and choose_kernel(g, fc) == "cuda"
    assert choose_kernel(g, dw) is None
    with pytest.raises(NotImplementedError, match=act):
        depthwise.act_args(act, attrs)
    with pytest.raises(NotImplementedError, match=act):
        dw_pw_fused.act_args(act, attrs)
    assert act not in km.ACTS and act in km.GEMM_ACTS
    for other in ("sigmoid", "swish"):
        with pytest.raises(NotImplementedError, match=other):
            km.act_code(other, None, km.GEMM_ACTS)


def test_fused_block_with_gelu_stays_torch():
    from paddle_lite_tpu_torch.ops.fused import dw_pw_fuse

    g = Graph("t")
    g.add_var("x", (1, 8, 8, 16))
    g.add_weight("dw", np.zeros((3, 3, 1, 16), np.int8))
    g.add_weight("pw", np.zeros((1, 1, 16, 8), np.int8))
    g.add_var("y", (1, 8, 8, 16))
    g.add_var("z", (1, 8, 8, 8))
    g.inputs, g.outputs = ["x"], ["z"]
    base = {"enable_int8": True, "strides": [1, 1]}
    g.add_op("depthwise_conv2d", {"Input": ["x"], "Filter": ["dw"]}, {"Output": ["y"]},
             dict(base, paddings=[1, 1], groups=16, fuse_act="relu", out_scale=0.1))
    g.add_op("conv2d", {"Input": ["y"], "Filter": ["pw"]}, {"Output": ["z"]},
             dict(base, paddings=[0, 0], fuse_act="gelu", act_attrs={"approximate": True}))
    g.rebuild_links()
    dw_pw_fuse(g)
    (op,) = g.ops
    assert op.op_type == "fused_dw_pw" and op.attrs["kernel"] == "torch"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "python3 chip_smoke.py runs the full check on the card")
    return torch.device("cuda")


def test_gemm_gelu_tanh_kernel_vs_plain_on_card(cuda_device):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-127, 128, (300, 1024)).astype(np.int8)).to(cuda_device)
    w = torch.from_numpy(rng.integers(-127, 128, (1024, 256)).astype(np.int8)).to(cuda_device)
    eff = torch.full((256,), 2e-4, device=cuda_device)
    bias = torch.zeros(256, device=cuda_device)
    for act, attrs in (("gelu", {"approximate": True}), ("gelu", {}), ("tanh", None)):
        for out_scale in (None, 0.05):
            got = km.int8_matmul(x, w, eff, bias, act=act, act_attrs=attrs, out_scale=out_scale)
            ref = km.int8_matmul_plain(x, w, eff, bias, act=act, act_attrs=attrs,
                                       out_scale=out_scale)
            if out_scale is None:
                torch.testing.assert_close(got, ref, rtol=GEMM_RTOL, atol=GEMM_ATOL)
            else:
                d = (got.int() - ref.int()).abs()
                assert testing.within_tie_bound([{"numel": d.numel(), "n_diff": int((d > 0).sum()),
                                                  "max_diff": float(d.max())}])
        with pytest.raises(NotImplementedError):
            depthwise.dw_conv_int8(torch.zeros((1, 8, 8, 16), dtype=torch.int8, device=cuda_device),
                                   torch.zeros((3, 3, 1, 16), dtype=torch.int8, device=cuda_device),
                                   torch.ones(16, device=cuda_device), act=act, act_attrs=attrs)


class _FakeOp:
    def __init__(self, attrs):
        self.attrs = attrs


def test_new_ops_run_without_host_sync_on_card(cuda_device):
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32)).to(cuda_device)
    ids = torch.tensor([[0, 49, 50, -1, -51]], dtype=torch.int32, device=cuda_device)
    x = torch.from_numpy(rng.normal(size=(2, 6, 8)).astype(np.float32)).to(cuda_device)
    lookup = OPS.get("lookup_table").impls["torch"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = lookup(None, None, {"W": [w], "Ids": [ids]})["Out"][0]
        split = OPS.get("split").impls["torch"](None, _FakeOp({"axis": 2, "num": 2}),
                                                 {"X": [x]})["Out"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isnan(out[0, 2]).all() and torch.isnan(out[0, 4]).all()
    assert torch.equal(out[0, 3], w[49]) and len(split) == 2


# ---- the model -------------------------------------------------------------------

def test_build_matches_reference():
    gr, gp = r_ernie.build(**KW), p_ernie.build(**KW)
    assert [o.op_type for o in gr.ops] == [o.op_type for o in gp.ops]
    for a, b in zip(gr.ops, gp.ops):
        assert a.inputs == b.inputs and a.outputs == b.outputs
        assert set(a.attrs) == set(b.attrs)
        for k in a.attrs:
            assert np.array_equal(np.asarray(a.attrs[k]), np.asarray(b.attrs[k])), (a.op_type, k)
    assert gr.inputs == gp.inputs and gr.outputs == gp.outputs
    assert {n: v.shape for n, v in gr.vars.items()} == {n: v.shape for n, v in gp.vars.items()}
    assert [gp.vars[n].precision.name for n in gp.inputs] == ["INT32", "INT32"]
    assert set(gr.weights) == set(gp.weights)
    for n, w in gr.weights.items():
        assert np.array_equal(np.asarray(w), gp.weights[n]), n


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    name = request.param
    calib = [_feed(1)]
    gr = r_ernie.build(**KW)
    r_optimize(gr, quant=_quant(name, "r"), calib_batches=calib)
    gp = p_ernie.build(**KW)
    optimize(gp, quant=_quant(name, "p"), calib_batches=calib, device="cpu")
    return name, gr, gp


def test_optimize_matches_reference(pair):
    """The same ops, attrs (fuse_act, act_attrs, out_scale) and scales; the
    port tags every int8 fc "cuda" (the GEMM with gelu and tanh in its
    epilogue) and leaves the matmuls on "torch"."""
    name, gr, gp = pair
    assert [o.op_type for o in gr.ops] == [o.op_type for o in gp.ops]
    for a, b in zip(gr.ops, gp.ops):
        assert a.inputs == b.inputs and a.outputs == b.outputs
        ka = {k: v for k, v in a.attrs.items() if k not in ("kernel", "out_scale", "alpha")}
        kb = {k: v for k, v in b.attrs.items() if k not in ("kernel", "out_scale", "alpha")}
        assert ka == kb, a.op_type
        assert a.attrs.get("alpha") == b.attrs.get("alpha")
        assert ("out_scale" in a.attrs) == ("out_scale" in b.attrs)
        if "out_scale" in a.attrs:
            np.testing.assert_allclose(b.attrs["out_scale"], a.attrs["out_scale"],
                                       rtol=SCALE_RTOL)
    for n, v in gr.vars.items():
        w = gp.vars[n]
        assert v.precision.value == w.precision.value and v.shape == w.shape, n
        assert (v.quant is None) == (w.quant is None), n
        if v.quant is not None:
            np.testing.assert_allclose(w.quant.scale, v.quant.scale,
                                       rtol=0 if v.is_weight else SCALE_RTOL)
    for n, a in gr.weights.items():
        assert np.array_equal(np.asarray(a), gp.weights[n]), n
    fcs = [o for o in gp.ops if o.op_type == "fc"]
    assert len(fcs) == 2 * 4 + 2 and all(o.attrs.get("enable_int8") for o in fcs)
    assert all(o.attrs.get("kernel") == "cuda" for o in fcs)
    assert [o.attrs.get("fuse_act") for o in fcs].count("gelu") == 2
    assert [o.attrs.get("fuse_act") for o in fcs].count("tanh") == 1
    gelu = {repr(o.attrs.get("act_attrs")) for o in fcs if o.attrs.get("fuse_act") == "gelu"}
    assert gelu == {repr({"approximate": True})}
    matmuls = [o for o in gp.ops if o.op_type == "matmul"]
    assert len(matmuls) == 4 and not any(o.attrs.get("kernel") for o in matmuls)
    assert all(o.attrs.get("enable_int8", False) == (name == "act_act") for o in matmuls)
    assert gp.meta.get("island_dtype") == gr.meta.get("island_dtype") == (
        "bfloat16" if name == "zoo" else None)


def _ref_capture(graph, feed):
    env = {}
    fn = R.build_callable(graph, platform="cpu", capture=lambda n, v: env.__setitem__(n, v))
    out = fn(R.stage_weights(graph), feed)
    return env, out


def test_graph_from_reference_carries_ernie(pair):
    """The int32 inputs, the embedding tables, the split / slice attrs, the
    gelu's act_attrs and the islands come across as the reference has
    them."""
    _, gr, _ = pair
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    assert gp.meta == gr.meta
    assert [gp.vars[n].precision.name for n in gp.inputs] == ["INT32", "INT32"]
    for n in ("word_emb", "pos_emb", "seg_emb"):
        assert gp.weights[n].dtype == np.float32
        assert np.array_equal(gp.weights[n], np.asarray(gr.weights[n]))
    for a, b in zip(gr.ops, gp.ops):
        assert a.op_type == b.op_type and a.inputs == b.inputs and a.outputs == b.outputs
        for k in ("sections", "axis", "axes", "starts", "ends", "decrease_axis",
                  "fuse_act", "act_attrs", "out_scale", "transpose_Y", "alpha"):
            if k in a.attrs:
                assert np.array_equal(np.asarray(b.attrs[k]), np.asarray(a.attrs[k])), k


def test_fp32_end_to_end():
    gr, gp = r_ernie.build(**KW), p_ernie.build(**KW)
    r_optimize(gr)
    optimize(gp, device="cpu")
    feed = _feed(2)
    _, ref = _ref_capture(gr, feed)
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)
    k = gr.outputs[0]
    np.testing.assert_allclose(got[k].numpy(), _np(ref[k]), rtol=0, atol=FP32_PROB_ATOL)


def test_int8_end_to_end(pair):
    """The probabilities: the reference's optimized graph run by the port,
    and each package's own optimized graph."""
    _, gr, gp = pair
    feed = _feed(2)
    _, ref = _ref_capture(gr, feed)
    gx = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    k = gr.outputs[0]
    for g, tol in ((gx, testing.SOFTMAX_ATOL), (gp, OWN_GRAPHS_PROB_ATOL)):
        out = P.build_callable(g, device=CPU)(P.stage_weights(g, CPU), feed)[k]
        assert out.dtype == torch.float32 and tuple(out.shape) == (KW["batch"], 2)
        np.testing.assert_allclose(out.numpy(), _np(ref[k]), rtol=0, atol=tol)


def test_op_by_op_on_reference_inputs(pair):
    """Each op of the reference's optimized graph, run by the port on the
    inputs the reference's run gave it (an fp32 result rounded to bf16 as
    the executor rounds it under islands), against the reference's
    output."""
    name, gr, _ = pair
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    env, _ = _ref_capture(gr, _feed(8))
    w = P.stage_weights(gp, CPU)
    ctx = ExecutionContext(graph=gp, device=CPU)
    island = torch.bfloat16 if gp.meta.get("island_dtype") == "bfloat16" else None
    n_int8 = 0
    for op in gp.topological_order():
        ins = {s: [_torch_of(env[n]) if n in env else w[n] for n in ns]
               for s, ns in op.inputs.items() if ns}
        outs = OPS.get(op.op_type).impl_for(op.attrs.get("kernel"))(ctx, op, ins)
        for slot, arrs in outs.items():
            for n, a in zip(op.outputs[slot], arrs):
                if island is not None and a.dtype == torch.float32:
                    a = a.to(island)
                r = _torch_of(env[n])
                assert a.dtype == r.dtype and a.shape == r.shape, (op.op_type, n)
                d = (a.double() - r.double()).abs()
                if a.dtype == torch.int8:
                    n_int8 += 1
                    diff = {"numel": d.numel(), "n_diff": int((d > 0).sum()),
                            "max_diff": float(d.max())}
                    if op.attrs.get("fuse_act") in ("gelu", "tanh"):
                        assert testing.within_tie_bound([diff]), (op.op_type, n, diff)
                    else:
                        assert diff["n_diff"] == 0, (op.op_type, n, diff)
                elif a.dtype == torch.float32:
                    torch.testing.assert_close(a, r, rtol=OP_TOL, atol=OP_TOL)
                elif a.dtype == torch.bfloat16:
                    assert bool((d <= BF16_ULP * r.double().abs()).all()), (op.op_type, n)
                else:
                    assert float(d.max()) == 0.0, (op.op_type, n)
    # quantize ops, int8 fcs and (act x act) the matmuls' int8 outputs
    assert n_int8 >= {"default": 12, "zoo": 12, "act_act": 20}[name]


def test_cuda_ops_within_tie_bound_of_torch_ops(pair):
    """The port's own graph: every "cuda" op (on the CPU, the kernels'
    plain versions) against its "torch" op on the inputs it got."""
    _, _, gp = pair
    local = testing.op_local_diffs(gp, P.stage_weights(gp, CPU), _feed(3), CPU)
    assert len(local) == 2 * 4 + 2 and testing.within_tie_bound(local)


def test_islands_keep_ids_int32_and_stage_tables_bf16():
    """Under the zoo config's bf16 islands the token and segment ids stay
    int32, the embedding tables are staged as bf16 (int8 weights as they
    are) and the lookups give bf16 rows, as in the reference's run."""
    gr, gp = r_ernie.build(**KW), p_ernie.build(**KW)
    r_optimize(gr, quant=_quant("zoo", "r"), calib_batches=[_feed(1)])
    optimize(gp, quant=_quant("zoo", "p"), calib_batches=[_feed(1)], device="cpu")
    w = P.stage_weights(gp, CPU)
    assert all(w[n].dtype == torch.bfloat16 for n in ("word_emb", "pos_emb", "seg_emb"))
    assert w["l0.ffn1.w"].dtype == torch.int8
    env = testing.capture_all(gp, w, _feed(4), CPU)
    ref, _ = _ref_capture(gr, _feed(4))
    for op in gp.ops:
        if op.op_type == "lookup_table":
            ids, out = op.input("Ids"), op.output("Out")
            assert env[ids].dtype == torch.int32 and env[out].dtype == torch.bfloat16
            assert str(ref[ids].dtype) == "int32" and str(ref[out].dtype) == "bfloat16"
            np.testing.assert_array_equal(env[out].float().numpy(), _np(ref[out]))
