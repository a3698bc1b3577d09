"""bf16 islands (``QuantConfig(island_dtype="bfloat16")``) through both
packages: the executor rounds every fp32 graph input and op output to bf16
between ops, stages fp32 weights as bf16, and returns fp32 outputs
(``paddle_lite_tpu/core/executor.py:86-136``).

MobileNetV1 (width 0.25, 32 px, batch 2, 10 classes) and SSD (the SSD
test's 160 px, batch 2, 5 classes; SSD's zoo config asks for bf16
islands).  Inputs are made with numpy from a seed.

Tolerances, and why:
- activation scales: rtol 1e-5, as without islands (calibration runs the
  fp32 graph; the island is stamped after it);
- the reference's optimized graph run by both packages: int8 tensors at
  most 1 % of elements off, by at most 3 LSB (the SSD test's bound);
  MobileNetV1's softmax within 2^-7 (its input, the fc's fp32 output, and
  its output are rounded to bf16: 2^-9 relative, and a logit one bf16 ulp
  apart moves a probability by about as much); SSD's scores within 2^-7
  and decoded boxes within 2^-7 (normalized coordinates rounded to bf16 at
  each of box_coder's inputs and its output: 2^-9 relative of values up to
  about 1.5);
- op by op, each port op fed the reference's captured inputs: every int8
  and bf16 output equal, bit for bit (the ops accumulate bf16 operands in
  fp32 and promote as jnp does); the NMS rows equal to the reference's
  Pallas impl's (which upcasts its bf16 inputs as the port does; its xla
  impl runs NMS in bf16, another function);
- ``quantize`` of a bf16 value: the fp32 quotient rounded, exactly.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.models import mobilenet_v1 as r_mnv1
from paddle_lite_tpu.models import ssd as r_ssd
from paddle_lite_tpu.ops import common as r_common
from paddle_lite_tpu.tools.opt import optimize as r_optimize
from paddle_lite_tpu_torch import testing
from paddle_lite_tpu_torch.core.executor import ExecutionContext
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.models import mobilenet_v1 as p_mnv1
from paddle_lite_tpu_torch.models import ssd as p_ssd
from paddle_lite_tpu_torch.models.zoo_config import recommended_quant
from paddle_lite_tpu_torch.ops import common
from paddle_lite_tpu_torch.tools.opt import optimize

CPU = torch.device("cpu")
SCALE_RTOL = 1e-5
INT8_FRACTION, INT8_LSB = 1e-2, 3
PROB_ATOL = BOX_ATOL = 2.0 ** -7
BF16 = "bfloat16"

MODELS = {
    "mobilenet_v1": (r_mnv1, p_mnv1, dict(batch=2, image_size=32, width_mult=0.25,
                                          num_classes=10, seed=0), (2, 32, 32, 3)),
    "ssd": (r_ssd, p_ssd, dict(batch=2, image_size=160, num_classes=5, seed=0),
            (2, 160, 160, 3)),
}


def _feed(name, seed):
    return {"image": np.random.default_rng(seed).normal(size=MODELS[name][3])
            .astype(np.float32)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    name = request.param
    r_mod, p_mod, kw, _ = MODELS[name]
    calib = [_feed(name, 1)]
    gr = r_mod.build(**kw)
    r_optimize(gr, quant=R.QuantConfig(island_dtype=BF16), calib_batches=calib)
    gp = p_mod.build(**kw)
    optimize(gp, quant=P.QuantConfig(island_dtype=BF16), calib_batches=calib, device="cpu")
    if name == "ssd":  # the same function in both: the exact top-k NMS
        for g, tag in ((gr, "xla"), (gp, "torch")):
            next(o for o in g.ops if o.op_type == "multiclass_nms").attrs["kernel"] = tag
    return name, gr, gp


def _ref_capture(graph, feed):
    env = {}
    R.build_callable(graph, platform="cpu", capture=lambda n, v: env.__setitem__(n, v))(
        R.stage_weights(graph), feed)
    return env


def _torch_of(v):
    a = np.asarray(jax.device_get(v))
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def test_ssd_zoo_config_asks_for_bf16_islands():
    assert recommended_quant("ssd").island_dtype == BF16


def test_optimize_matches_reference(pair):
    name, gr, gp = pair
    assert gp.meta["island_dtype"] == gr.meta["island_dtype"] == BF16
    assert [o.op_type for o in gr.ops] == [o.op_type for o in gp.ops]
    for a, b in zip(gr.ops, gp.ops):
        if "out_scale" in a.attrs:
            np.testing.assert_allclose(b.attrs["out_scale"], a.attrs["out_scale"],
                                       rtol=SCALE_RTOL)
    for n, v in gr.vars.items():
        if v.quant is not None:
            np.testing.assert_allclose(gp.vars[n].quant.scale, v.quant.scale,
                                       rtol=0 if v.is_weight else SCALE_RTOL)


def test_weights_staged_bf16_int8_untouched(pair):
    name, gr, gp = pair
    w = P.stage_weights(gp, CPU)
    rw = R.stage_weights(gr)
    n_int8 = n_bf16 = 0
    for k, v in gp.weights.items():
        if v.dtype == np.int8:
            n_int8 += 1
            assert w[k].dtype == torch.int8 and np.array_equal(w[k].numpy(), v)
        else:
            n_bf16 += 1
            assert w[k].dtype == torch.bfloat16
            # rounded to nearest even, as the reference's astype(bfloat16)
            np.testing.assert_array_equal(w[k].float().numpy(),
                                          np.asarray(rw[k]).astype(np.float32))
    assert n_int8 > 5 and n_bf16 > 5


def test_reference_graph_end_to_end(pair):
    name, gr, _ = pair
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    assert gp.meta["island_dtype"] == BF16  # interop carries the island
    feed = _feed(name, 2)
    ref = _ref_capture(gr, feed)
    got = testing.capture_all(gp, P.stage_weights(gp, CPU), feed, CPU)
    n_int8 = n_bf16 = 0
    for n, r in ref.items():
        g = got[n]
        assert str(g.dtype).split(".")[-1] == str(r.dtype) and tuple(g.shape) == r.shape, n
        if r.dtype == jnp.int8:
            n_int8 += 1
            d = np.abs(g.numpy().astype(np.int32) - np.asarray(r).astype(np.int32))
            assert d.max() <= INT8_LSB and (d > 0).mean() <= INT8_FRACTION, n
        n_bf16 += r.dtype == jnp.bfloat16
    assert n_int8 >= 10 and n_bf16 >= 2
    out = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)
    ref_out = R.build_callable(gr, platform="cpu")(R.stage_weights(gr), feed)
    for n in gr.outputs:  # the public contract: fp32
        assert out[n].dtype == torch.float32 and ref_out[n].dtype == jnp.float32
    if name == "mobilenet_v1":
        np.testing.assert_allclose(out[gr.outputs[0]].numpy(), np.asarray(ref_out[gr.outputs[0]]),
                                   rtol=0, atol=PROB_ATOL)
    else:
        nms = next(o for o in gr.ops if o.op_type == "multiclass_nms")
        for slot, tol in (("Scores", PROB_ATOL), ("BBoxes", BOX_ATOL)):
            n = nms.input(slot)
            assert got[n].dtype == torch.bfloat16  # the NMS op's input dtype
            np.testing.assert_allclose(got[n].float().numpy(),
                                       np.asarray(ref[n]).astype(np.float32), rtol=0, atol=tol)


def test_op_by_op_on_reference_inputs(pair):
    """Each op of the reference's optimized island graph, run by the port
    on the reference's captured inputs: int8 and bf16 outputs equal bit
    for bit (an op's fp32 result after the executor's bf16 rounding)."""
    name, gr, _ = pair
    gp = graph_from_reference(artifact.graph_to_meta(gr), gr.weights)
    env = _ref_capture(gr, _feed(name, 3))
    w = P.stage_weights(gp, CPU)
    ctx = ExecutionContext(graph=gp, device=CPU)
    for op in gp.topological_order():
        if op.op_type == "multiclass_nms":
            continue  # the reference's xla NMS runs in bf16: the next test
        ins = {s: [_torch_of(env[n]) if n in env else w[n] for n in ns]
               for s, ns in op.inputs.items() if ns}
        outs = OPS.get(op.op_type).impl_for(op.attrs.get("kernel"))(ctx, op, ins)
        for slot, arrs in outs.items():
            for n, a in zip(op.outputs[slot], arrs):
                a = a.to(torch.bfloat16) if a.dtype == torch.float32 else a
                r = _torch_of(env[n])
                assert a.dtype == r.dtype and a.shape == r.shape, n
                assert torch.equal(a, r), (op.op_type, n)


def test_nms_on_island_inputs_matches_reference_pallas(pair):
    """The NMS op reads bf16 boxes and scores under islands.  The
    reference's Pallas impl upcasts them to fp32 (``detection.py:424-425``
    there), as both of the port's impls do; its xla impl runs in bf16,
    another function.  Fed the reference's captured island inputs, the
    port's "cuda" impl (its plain version on the CPU) gives the Pallas
    impl's rows (interpret mode) exactly, and the torch impl gives the
    same rows with the exact top-k tier."""
    from paddle_lite_tpu.core.executor import ExecutionContext as RContext
    from paddle_lite_tpu.ops import detection as r_det

    name, gr, gp = pair
    if name != "ssd":
        pytest.skip("SSD only")
    env = _ref_capture(gr, _feed(name, 4))
    op_r = next(o for o in gr.ops if o.op_type == "multiclass_nms")
    op_p = copy.deepcopy(next(o for o in gp.ops if o.op_type == "multiclass_nms"))
    ins_r = {s: [env[op_r.input(s)]] for s in ("BBoxes", "Scores")}
    ins_p = {s: [_torch_of(env[op_r.input(s)])] for s in ("BBoxes", "Scores")}
    assert ins_p["Scores"][0].dtype == torch.bfloat16
    want = r_det.multiclass_nms_pallas(RContext(graph=gr, platform="cpu", interpret=True),
                                       op_r, ins_r)["Out"][0]
    got = OPS.get("multiclass_nms").impls["cuda"](None, op_p, ins_p)["Out"][0]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    op_p.attrs["approx_top_k"] = False
    a = OPS.get("multiclass_nms").impls["cuda"](None, op_p, ins_p)["Out"][0]
    b = OPS.get("multiclass_nms").impls["torch"](None, op_p, ins_p)["Out"][0]
    assert torch.equal(a, b)


def test_compiled_equals_eager_and_outputs_fp32(pair):
    name, _, gp = pair
    g = copy.deepcopy(gp)
    if name == "ssd":
        next(o for o in g.ops if o.op_type == "multiclass_nms").attrs["kernel"] = "cuda"
    fn, w = P.compile_graph(g, device=CPU)
    assert fn._inputs["image"].dtype == torch.float32  # the static buffer stays fp32
    feed = _feed(name, 5)
    a, b = fn(w, feed), P.build_callable(g, device=CPU)(w, feed)
    for n in g.outputs:
        assert a[n].dtype == torch.float32 and torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("x,scale", [(1.0, 1.0 / 2.505), (-3.0, 3.0 / 2.505),
                                     (0.8125, 0.8125 / 6.505)])
def test_quantize_rounds_a_bf16_value_in_fp32(x, scale):
    """jnp divides a bf16 array by a float32 scale in float32; PyTorch would
    keep bf16 against the 0-dim float32 scale and round x / s to bf16 first
    (2.505 → 2.5 → 2, against 3 in float32)."""
    xb = torch.tensor([x], dtype=torch.bfloat16)
    want = np.asarray(r_common.quantize(jnp.asarray([x], jnp.bfloat16), np.float32(scale)))
    q = common.quantize(xb, scale)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), want)
    exact = np.round(np.float32(xb.float().item()) / np.float32(scale))
    assert q.item() == exact
    in_bf16 = torch.round(xb / torch.tensor(np.float32(scale))).item()
    assert in_bf16 != exact  # the trap this guards


def test_cuda_tags_vs_torch_tags(pair):
    """The port's own island graph, every "cuda" op (its plain version on
    the CPU; a bf16-staged bias upcast to fp32, values kept) against its
    "torch" op on identical inputs, both outputs rounded to bf16 as the
    executor rounds them: within rounding ties."""
    name, _, gp = pair
    g = copy.deepcopy(gp)
    if name == "ssd":
        next(o for o in g.ops if o.op_type == "multiclass_nms").attrs["kernel"] = "cuda"
    diffs = testing.op_local_diffs(g, P.stage_weights(g, CPU), _feed(name, 6), CPU)
    assert len(diffs) >= 14 and testing.within_tie_bound(diffs)


def test_cuda_impl_raises_on_bf16_operands(pair):
    """A kernel takes int8 operands and fp32 bias and scales: a bf16
    operand raises instead of being converted."""
    name, _, gp = pair
    op = next(o for o in gp.ops if o.op_type == "conv2d" and o.attrs.get("kernel") == "cuda")
    w = P.stage_weights(gp, CPU)
    x = torch.zeros(gp.vars[op.input("Input")].shape, dtype=torch.bfloat16)
    ins = {"Input": [x], "Filter": [w[op.input("Filter")]]}
    with pytest.raises(ValueError, match="int8"):
        OPS.get("conv2d").impls["cuda"](ExecutionContext(graph=gp, device=CPU), op, ins)
