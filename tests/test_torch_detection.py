"""The port's detection ops, ``concat`` and NMS kernel module against the JAX
package.  Inputs are made with numpy from a seed and handed to both.

Tolerances, and why:
- ``prior_box``, ``box_coder``, ``concat``: rtol 1e-6, and atol 2.5e-7
  (two ulps at 1.0) for values that cancel to near 0, as the unnormalized
  decode's ``x − 1`` does.  ``prior_box`` is the same float32 arithmetic;
  XLA on the CPU may contract ``v·t·pw + pcx`` in ``box_coder`` into one
  FMA where torch rounds twice, and the two ``exp`` differ by an ulp.
  ``concat`` is exact (measured), and so held.
- NMS: exact.  ``nms_keep_scores_plain`` computes the Pallas kernel's
  function with the same fp32 operations; ``multiclass_nms`` under both
  tags is fed the very inputs the JAX op gets.  In these data the box
  pair nearest the IoU threshold (non-empty union) sits 1.7e-5 of its
  union away from it, some 140 ulps, so FMA contraction in XLA's interpret
  mode cannot flip a test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.executor import ExecutionContext as RContext
from paddle_lite_tpu.core.ir import Graph as RGraph
from paddle_lite_tpu.core.types import Precision as RPrecision
from paddle_lite_tpu.core.types import QuantInfo as RQuant
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.ops import detection as r_det
from paddle_lite_tpu.ops.kernels import nms as r_nms
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.ops import detection as p_det
from paddle_lite_tpu_torch.ops.kernels import nms as p_nms
from paddle_lite_tpu_torch.ops.kernels import ops_cuda

CPU = torch.device("cpu")
RTOL, ATOL = 1e-6, 2.5e-7
IOU_T, SCORE_T = 0.45, 0.01


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _run_both(g: RGraph, feed):
    g.rebuild_links()
    ref = R.build_callable(g, platform="cpu")(R.stage_weights(g), feed)
    ref = {k: np.asarray(jax.device_get(v)) for k, v in ref.items()}
    gp = graph_from_reference(artifact.graph_to_meta(g), g.weights)
    got = P.build_callable(gp, device=CPU)(P.stage_weights(gp, CPU), feed)
    return ref, {k: v.numpy() for k, v in got.items()}


def _assert_close(ref, got):
    for k in ref:
        assert ref[k].shape == got[k].shape and ref[k].dtype == got[k].dtype, k
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL)


# ---- prior_box / box_coder / concat ----------------------------------------

@pytest.mark.parametrize("attrs,feat_hw,img_hw", [
    # SSD-300's first and last taps
    ({"min_sizes": [30.0], "max_sizes": [60.0], "aspect_ratios": [2.0],
      "flip": True, "clip": True, "variances": [0.1, 0.1, 0.2, 0.2]},
     (19, 19), (300, 300)),
    ({"min_sizes": [261.0], "max_sizes": [300.0], "aspect_ratios": [2.0, 3.0],
      "flip": True, "clip": True, "variances": [0.1, 0.1, 0.2, 0.2]},
     (1, 1), (300, 300)),
    # non-square, no clip, no flip, explicit steps and offset, two min sizes
    ({"min_sizes": [16.0, 40.0], "max_sizes": [32.0], "aspect_ratios": [3.0],
      "flip": False, "clip": False, "step_w": 9.0, "step_h": 7.0,
      "offset": 0.25}, (6, 9), (48, 80)),
])
def test_prior_box_matches_reference(attrs, feat_hw, img_hw):
    g = RGraph("t")
    g.add_var("feat", (1,) + feat_hw + (8,))
    g.add_var("image", (1,) + img_hw + (3,))
    g.inputs += ["feat", "image"]
    shapes = r_det.prior_box_shape(attrs, [(1,) + feat_hw + (8,)])
    for n, s in zip(("boxes", "vars"), shapes):
        g.add_var(n, s)
        g.outputs.append(n)
    g.add_op("prior_box", {"Input": ["feat"], "Image": ["image"]},
             {"Boxes": ["boxes"], "Variances": ["vars"]}, attrs)
    rng = np.random.default_rng(0)
    feed = {"feat": rng.normal(size=(1,) + feat_hw + (8,)).astype(np.float32),
            "image": rng.normal(size=(1,) + img_hw + (3,)).astype(np.float32)}
    ref, got = _run_both(g, feed)
    _assert_close(ref, got)
    assert p_det.prior_box_shape(attrs, [(1,) + feat_hw + (8,)]) == shapes


def test_prior_box_is_computed_once_per_op():
    attrs = {"min_sizes": [30.0], "max_sizes": [60.0], "aspect_ratios": [2.0]}
    ctx = P.core.executor.ExecutionContext(graph=None, device=CPU)

    class Op:
        id = 0
        op_type = "prior_box"

    Op.attrs = attrs
    ins = {"Input": [torch.zeros(1, 5, 5, 4)], "Image": [torch.zeros(1, 50, 50, 3)]}
    a = OPS.get("prior_box").impls["torch"](ctx, Op(), ins)["Boxes"][0]
    b = OPS.get("prior_box").impls["torch"](ctx, Op(), ins)["Boxes"][0]
    assert a is b and a.shape == (5, 5, 4, 4)


@pytest.mark.parametrize("with_var,normalized", [(True, True), (False, True),
                                                 (True, False)])
def test_box_coder_matches_reference(with_var, normalized):
    rng = np.random.default_rng(1)
    m, n = 200, 3
    c = rng.uniform(0.05, 0.95, (m, 2))
    wh = rng.uniform(0.02, 0.5, (m, 2))
    prior = np.clip(np.concatenate([c - wh / 2, c + wh / 2], -1), 0, 1)
    g = RGraph("t")
    ins = {"PriorBox": ["prior"], "TargetBox": ["target"]}
    g.add_var("prior", (m, 4))
    g.inputs.append("prior")
    feed = {"prior": prior.astype(np.float32),
            "target": rng.normal(0, 1.5, (n, m, 4)).astype(np.float32)}
    if with_var:
        g.add_var("pvar", (m, 4))
        g.inputs.append("pvar")
        ins["PriorBoxVar"] = ["pvar"]
        feed["pvar"] = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (m, 1))
    g.add_var("target", (n, m, 4))
    g.inputs.append("target")
    g.add_var("out", (n, m, 4))
    g.outputs.append("out")
    g.add_op("box_coder", ins, {"OutputBox": ["out"]},
             {"code_type": "decode_center_size", "box_normalized": normalized})
    ref, got = _run_both(g, feed)
    _assert_close(ref, got)


@pytest.mark.parametrize("int8_region", [False, True])
def test_concat_both_forms_match_reference(int8_region):
    """fp32 form: int8 inputs dequantize (one fp32 input among them);
    int8 form: every input requants to the common out_scale."""
    rng = np.random.default_rng(2)
    scales = [0.02, 0.05, 0.035]
    out_scale = 0.05
    g = RGraph("t")
    feed, names = {}, []
    for i, s in enumerate(scales):
        name = f"x{i}"
        fp32_input = not int8_region and i == 1
        v = g.add_var(name, (2, 5 + i, 7), precision=RPrecision.FP32
                      if fp32_input else RPrecision.INT8)
        if not fp32_input:
            v.quant = RQuant.per_tensor(s)
            feed[name] = rng.integers(-127, 128, (2, 5 + i, 7), dtype=np.int8)
        else:
            feed[name] = rng.normal(size=(2, 5 + i, 7)).astype(np.float32)
        g.inputs.append(name)
        names.append(name)
    attrs = {"axis": 1}
    out = g.add_var("out", (2, 18, 7), precision=RPrecision.INT8 if int8_region
                    else RPrecision.FP32)
    if int8_region:
        attrs["out_scale"] = out_scale
        out.quant = RQuant.per_tensor(out_scale)
    g.outputs.append("out")
    g.add_op("concat", {"X": names}, {"Out": ["out"]}, attrs)
    ref, got = _run_both(g, feed)
    assert got["out"].dtype == (np.int8 if int8_region else np.float32)
    if int8_region:
        np.testing.assert_array_equal(got["out"], ref["out"])
    else:
        _assert_close(ref, got)


# ---- the NMS kernel module --------------------------------------------------

def _candidates(rng, g, k):
    centers = rng.uniform(0.1, 0.9, (g, k, 2))
    wh = rng.uniform(0.02, 0.35, (g, k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    scores = rng.uniform(0, 1, (g, k)).astype(np.float32)
    scores[:, ::3] *= 0.005                   # a third below score_t
    scores[0, 40:60] = scores[0, 7]           # tied scores, unsorted
    scores[1, 100:140] = np.float32(0.5)      # a block of ties
    scores[2] = 0.004                          # an all-invalid instance
    return boxes.astype(np.float32), scores


@pytest.mark.parametrize("k", [528, 400])
def test_nms_plain_matches_pallas_and_reference(k):
    """Unsorted candidates, tied scores, an all-invalid instance; k = 528
    (SSD's bucket3@176 tier) and 400 (the exact tier's nms_top_k)."""
    boxes, scores = _candidates(np.random.default_rng(k), 4, k)
    pallas = np.asarray(r_nms.nms_keep_scores(
        jnp.asarray(boxes), jnp.asarray(scores), iou_t=IOU_T, score_t=SCORE_T,
        interpret=True))
    greedy = r_nms.nms_reference(boxes, scores, iou_t=IOU_T, score_t=SCORE_T)
    p_nms.launches = 0
    got = p_nms.nms_keep_scores(_t(boxes), _t(scores), iou_t=IOU_T,
                                score_t=SCORE_T)
    assert p_nms.launches == 0  # CPU tensors: the plain version
    got = got.numpy()
    np.testing.assert_array_equal(got.view(np.int32), pallas.view(np.int32))
    np.testing.assert_array_equal(got, greedy)
    assert (got[2] == 0).all() and (got[0] > 0).sum() > 10
    # ties and suppression both happen in this data
    assert (got[1, 100:140] > 0).sum() not in (0, 40)


def test_nms_plain_sorted_input_matches_single_class():
    """On score-descending candidates the kernel's function equals the
    torch tag's Jacobi fixed point (``iou > t`` by division)."""
    boxes, scores = _candidates(np.random.default_rng(5), 3, 96)
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    scores = np.take_along_axis(scores, order, 1)
    a = p_nms.nms_keep_scores_plain(_t(boxes), _t(scores), iou_t=IOU_T,
                                    score_t=SCORE_T)
    b = p_det.nms_single_class(_t(boxes), _t(scores), IOU_T, SCORE_T)
    assert torch.equal(a, b)


def test_topk_stable_is_jax_top_k():
    x = np.float32([0.0, -0.0, 0.5, -1e30, 0.5, -np.inf, 0.0, -0.0, 0.25, -1e30])
    x = np.tile(x, (3, 1))
    x[1] = x[1][::-1]
    x[2] = np.random.default_rng(0).permutation(x[2])
    rv, ri = jax.lax.top_k(jnp.asarray(x), 7)
    pv, pi = p_det.topk_stable(_t(x), 7)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pv.numpy().view(np.int32),
                                  np.asarray(rv).view(np.int32))


def test_bucket_gather_equals_one_hot_sum():
    """The port takes each bucket max's box by gather; the reference by a
    one-hot sum (``detection.py:473-480``).  Equal for finite boxes."""
    rng = np.random.default_rng(3)
    n, m, c, loc, topn = 2, 150, 4, 16, 3
    boxes = _t(rng.uniform(-0.2, 1.2, (n, m, 4)).astype(np.float32))
    scores = rng.dirichlet(np.ones(c) * 0.3, (n, m)).astype(np.float32)
    scores[0, :20, 1] = 0.25  # ties inside buckets
    scores = _t(scores)
    top_s, cand = ops_cuda.bucket_candidates(boxes, scores, topn, loc)
    # the reference's form, written out in torch
    bs = -(-m // loc)
    pad = loc * bs - m
    sc_b = torch.nn.functional.pad(scores.transpose(1, 2), (0, pad),
                                   value=-1e30).reshape(n, c, loc, bs)
    bx_b = torch.nn.functional.pad(boxes, (0, 0, 0, pad)).reshape(n, 1, loc, bs, 4)
    taken = torch.zeros_like(sc_b, dtype=torch.bool)
    tops, cands = [], []
    for _ in range(topn):
        sb = torch.where(taken, torch.tensor(float("-inf")), sc_b)
        top = sb.max(dim=-1).values
        sel = sb == top[..., None]
        onehot = sel & (torch.cumsum(sel.int(), dim=-1) == 1)
        taken = taken | onehot
        tops.append(top)
        cands.append((onehot.float()[..., None] * bx_b).sum(dim=3))
    assert torch.equal(top_s, torch.cat(tops, -1))
    assert torch.equal(cand, torch.cat(cands, 2))


# ---- multiclass_nms under both tags ----------------------------------------

class _Op:
    op_type = "multiclass_nms"

    def __init__(self, **attrs):
        self.attrs = {"background_label": 0, "score_threshold": SCORE_T,
                      "nms_top_k": 400, "nms_threshold": IOU_T,
                      "keep_top_k": 100, **attrs}

    def input(self, s):
        return s


def _ssd_like(rng, n, m, c):
    """Spatially ordered priors (neighbours overlap, as SSD's do) with
    jittered decoded boxes, and softmax-like class scores."""
    side = int(np.ceil(np.sqrt(m / 4)))
    cells = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1)
    centers = ((cells.reshape(-1, 2) + 0.5) / side).repeat(4, 0)[:m]
    wh = np.tile(np.float32([[0.1, 0.1], [0.2, 0.2], [0.14, 0.07], [0.07, 0.14]]),
                 (side * side, 1))[:m]
    jit = rng.normal(0, 0.02, (n, m, 4))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)[None] + jit
    scores = rng.dirichlet(np.ones(c) * 0.3, (n, m))
    return boxes.astype(np.float32), scores.astype(np.float32)


TIERS = [dict(approx_top_k=False), dict(approx_top_k=True),
         dict(approx_top_k="bucket3", bucket_candidates=176),
         dict(approx_top_k="bucket3", bucket_candidates=176, keep_top_k=100,
              score_threshold=0.9)]      # fewer than keep_top_k survive


@pytest.mark.parametrize("attrs", TIERS)
@pytest.mark.parametrize("tags", [("pallas", "cuda"), ("xla", "torch")])
def test_multiclass_nms_matches_reference(attrs, tags):
    ref_tag, tag = tags
    rng = np.random.default_rng(4)
    boxes, scores = _ssd_like(rng, 2, 640, 5)   # SSD at 160 px: M = 640
    op = _Op(**attrs)
    ctx = RContext(graph=None, platform="cpu", interpret=True)
    r_impl = {"pallas": r_det.multiclass_nms_pallas,
              "xla": r_det.multiclass_nms_xla}[ref_tag]
    ref = np.asarray(r_impl(ctx, op, {"BBoxes": [jnp.asarray(boxes)],
                                      "Scores": [jnp.asarray(scores)]})["Out"][0])
    p_nms.launches = 0
    got = OPS.get("multiclass_nms").impls[tag](
        None, op, {"BBoxes": [_t(boxes)], "Scores": [_t(scores)]})["Out"][0]
    assert p_nms.launches == 0
    got = got.numpy()
    assert got.shape == ref.shape == (2, op.attrs["keep_top_k"], 6)
    np.testing.assert_array_equal(got, ref)
    n_valid = (got[..., 0] >= 0).sum(axis=1)
    if op.attrs["score_threshold"] > 0.5:
        assert (n_valid < 100).all() and (n_valid > 0).all()
    # multiclass_nms2 is the same op
    got2 = OPS.get("multiclass_nms2").impls[tag](
        None, op, {"BBoxes": [_t(boxes)], "Scores": [_t(scores)]})["Out"][0]
    assert torch.equal(got2, torch.from_numpy(got))


def test_multiclass_nms_cuda_impl_takes_a_keep_function():
    """The hook chip_smoke.py uses to hold the kernel's op output against
    the same op with the plain version."""
    boxes, scores = _ssd_like(np.random.default_rng(6), 1, 400, 4)
    attrs = _Op(approx_top_k="bucket3", bucket_candidates=64).attrs
    calls = []

    def keep(b, s, **kw):
        calls.append(tuple(b.shape))
        return p_nms.nms_keep_scores_plain(b, s, **kw)

    a = ops_cuda.multiclass_nms(_t(boxes), _t(scores), attrs, keep=keep)
    b = ops_cuda.multiclass_nms(_t(boxes), _t(scores), attrs)
    assert calls == [(4, 192, 4)] and torch.equal(a, b)


def test_nms_kernel_rejects_what_it_does_not_take():
    with pytest.raises(ValueError):
        p_nms._check(torch.zeros(2, 3, 4, dtype=torch.float64), "b", (2, 3, 4), CPU)
    with pytest.raises(ValueError, match="contiguous"):
        p_nms._check(torch.zeros(3, 2, 4).transpose(0, 1), "b", (2, 3, 4), CPU)


@pytest.mark.parametrize("op_type,int8", [("multiclass_nms", False),
                                          ("multiclass_nms2", True)])
def test_kernel_pick_takes_every_nms(op_type, int8):
    from paddle_lite_tpu_torch.core.ir import Graph
    from paddle_lite_tpu_torch.ops.kernels.select import choose_kernel

    g = Graph("t")
    g.add_var("b", (1, 8, 4))
    g.add_var("s", (1, 8, 3))
    g.add_var("o", (1, 100, 6))
    op = g.add_op(op_type, {"BBoxes": ["b"], "Scores": ["s"]}, {"Out": ["o"]},
                  {"enable_int8": int8})
    assert choose_kernel(g, op) == "cuda"


# ---- on the card: the CUDA kernel against its plain version ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "python3 chip_smoke.py runs the full check on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [528, 400, 33, 1])
def test_nms_kernel_vs_plain_on_card(cuda_device, k):
    boxes, scores = _candidates(np.random.default_rng(k), 8, k)
    b, s = _t(boxes).to(cuda_device), _t(scores).to(cuda_device)
    got = p_nms.nms_keep_scores(b, s, iou_t=IOU_T, score_t=SCORE_T)
    ref = p_nms.nms_keep_scores_plain(b, s, iou_t=IOU_T, score_t=SCORE_T)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_nms_kernel_refuses_k_past_shared_memory(cuda_device):
    b = torch.zeros(1, 4096, 4, device=cuda_device)
    with pytest.raises(ValueError, match="sort keys"):
        p_nms.nms_keep_scores(b, torch.ones(1, 4096, device=cuda_device),
                              iou_t=IOU_T, score_t=SCORE_T)
