"""Faster R-CNN's RPN through the port's ``Predictor``: ``generate_proposals``
on the NMS kernel's division form, held to the JAX package on the CPU.

- The ``"cuda"`` ``generate_proposals`` on a CPU tensor runs the kernel's
  plain version (``nms_keep_scores_plain(iou_form="div")``); its outputs
  equal the port's ``"torch"`` impl bit for bit, and the reference's
  ``"xla"`` op: the kept scores bit for bit (the same top-k steps, IoU test
  and greedy fixed point), the boxes within 1e-4 px (their decode's
  ``exp`` differs in the last bit between the two CPU libraries).
- ``nms_keep_scores_plain(iou_form="div")`` equals ``nms_single_class`` (the
  port's form of the reference's ``_nms_single_class``) bit for bit on
  score-sorted candidates; on a pair built where ``inter > t·union`` and
  ``inter / union > t`` round apart, ``"div"`` follows the reference and
  ``"mul"`` does not.
- The whole RPN graph (``models/faster_rcnn_rpn``) through ``Predictor`` on
  the CPU: the proposals bit-equal to the eager loop's and, as above, to
  the reference's; the pooled features equal the eager loop's bit for bit and
  the reference's within rtol / atol 1e-5 (``roi_align``'s bilinear sums
  in another order, ``test_torch_op_library``'s tolerance for it).
"""

import jax
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu.ops import detection as r_det
from paddle_lite_tpu_torch.core import executor
from paddle_lite_tpu_torch.core.executor import build_callable, stage_weights
from paddle_lite_tpu_torch.core.registry import OPS
from paddle_lite_tpu_torch.formats import artifact as p_artifact
from paddle_lite_tpu_torch.models import faster_rcnn_rpn as rpn
from paddle_lite_tpu_torch.ops import detection as p_det
from paddle_lite_tpu_torch.ops.kernels import nms as p_nms
from paddle_lite_tpu_torch.ops.kernels import select
from paddle_lite_tpu_torch.runtime.predictor import Predictor, create_predictor
from paddle_lite_tpu_torch.testing import retag
from test_torch_compiled import no_host_round_trips  # noqa: F401  (a fixture)

CPU = torch.device("cpu")
FEAT, IMAGE = (12, 16, 8), (192, 256)
ATTRS = {**rpn.ATTRS,
         "generate_proposals": {**rpn.ATTRS["generate_proposals"], "pre_nms_topN": 2000,
                                "post_nms_topN": 300}}
POOL_TOL = 1e-5
# the boxes' decode takes exp(), whose last bit differs between the
# packages' CPU libraries, and a corner is a difference of the centre and
# half the width: the proposal boxes within 1e-4 px (coordinates up to 256
# px; the kept set and its scores equal bit for bit)
DECODE_ATOL = 1e-4



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores,
    and PyTorch's default of one thread a core each oversubscribes them
    (a timing test here then ran for minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t) -> np.ndarray:
    a = np.ascontiguousarray(t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t))
    return a.view(np.int32)


def _graph(tag="cuda"):
    g = rpn.build(FEAT, ATTRS)
    for op in g.ops:
        if op.op_type == "generate_proposals":
            op.attrs["kernel"] = tag
    return g


def _reference(pg, feed):
    rg = r_artifact.graph_from_meta(p_artifact.graph_to_meta(retag(pg, "cuda", "torch")))
    rg.weights = dict(pg.weights)
    rg.rebuild_links()
    weights = {k: jax.numpy.asarray(v) for k, v in R.stage_weights(rg).items()}
    out = R.build_callable(rg, platform="cpu")(weights, feed)
    return [np.asarray(jax.device_get(out[n])) for n in rg.outputs]


def test_generate_proposals_is_tagged_cuda_by_kernel_pick():
    g = rpn.build(FEAT, ATTRS)
    gp = next(op for op in g.ops if op.op_type == "generate_proposals")
    assert select.choose_kernel(g, gp) == "cuda"
    create_predictor(g, device="cpu")  # optimize: fusions, kernel pick
    assert gp.attrs["kernel"] == "cuda"
    assert not OPS.get("generate_proposals").syncs_host("cuda")
    assert OPS.get("generate_proposals").syncs_host("torch")
    assert executor.host_syncing_ops(g) == []
    assert [s.split()[0] for s in executor.host_syncing_ops(retag(g, "cuda", "torch"))] \
        == ["generate_proposals"]


@pytest.mark.parametrize("seed", [14, 3])
def test_cuda_generate_proposals_on_the_cpu_is_the_reference(seed):
    """The "cuda" impl's plain version (division form) against the
    reference's op, bit for bit, and against the port's "torch" impl."""
    feed = rpn.feed(FEAT, IMAGE, ATTRS, seed=seed)
    g = _graph("cuda")
    got = build_callable(g, device=CPU)(stage_weights(g, CPU), feed)
    gt = _graph("torch")
    eager_torch = build_callable(gt, device=CPU)(stage_weights(gt, CPU), feed)
    want = _reference(g, feed)
    rois, probs, _ = g.outputs
    for name in (rois, probs):
        np.testing.assert_array_equal(_bits(got[name]), _bits(eager_torch[name]))
    np.testing.assert_array_equal(_bits(got[probs]), _bits(want[1]))
    np.testing.assert_allclose(got[rois].numpy(), want[0], rtol=0, atol=DECODE_ATOL)
    assert 0 < int((got[probs] > 0).sum()) < ATTRS["generate_proposals"]["post_nms_topN"]


def test_rpn_graph_through_predictor_on_the_cpu():
    """Predictor (compile_graph's plan on the CPU) against the eager loop,
    bit for bit, and the reference (proposals bit for bit, pooled features
    within POOL_TOL)."""
    feed = rpn.feed(FEAT, IMAGE, ATTRS, seed=5)
    g = rpn.build(FEAT, ATTRS)
    pred = create_predictor(g, device="cpu")
    out = pred.run(feed)
    eager = build_callable(g, device=CPU)(pred._weights, feed)
    want = _reference(g, feed)
    for k, name in enumerate(g.outputs):
        assert torch.equal(out[name], eager[name])
        if k == 0:
            np.testing.assert_allclose(out[name].numpy(), want[k], rtol=0, atol=DECODE_ATOL)
        elif k == 1:
            np.testing.assert_array_equal(_bits(out[name]), _bits(want[k]))
        else:
            np.testing.assert_allclose(out[name].numpy(), want[k], rtol=POOL_TOL, atol=POOL_TOL)
    assert torch.equal(pred.run(feed)[g.outputs[1]], out[g.outputs[1]])


def test_rpn_request_has_no_host_round_trip_after_warm_up(no_host_round_trips):
    """The RPN's request path, after the warm-up: no value read back and no
    host array copied over (the NMS kernel's plain version, the CPU's
    stand-in for the kernel, exempted as test_torch_compiled exempts it)."""
    feed = {k: torch.from_numpy(v) for k, v in rpn.feed(FEAT, IMAGE, ATTRS, seed=8).items()}
    pred = create_predictor(rpn.build(FEAT, ATTRS), device="cpu")
    want = pred.run(feed)
    no_host_round_trips["on"] = True
    try:
        got = pred._fn(pred._weights, feed)
    finally:
        no_host_round_trips["on"] = False
    assert all(torch.equal(got[n], want[n]) for n in want)


def test_rpn_graph_survives_the_nbf_artifact(tmp_path):
    from paddle_lite_tpu_torch.runtime.predictor import load_predictor

    feed = rpn.feed(FEAT, IMAGE, ATTRS, seed=6)
    pred = create_predictor(rpn.build(FEAT, ATTRS), device="cpu")
    path = str(tmp_path / "rpn.nbf")
    pred.save(path)
    loaded = load_predictor(path, device="cpu")
    gp = next(op for op in loaded.graph.ops if op.op_type == "generate_proposals")
    assert gp.attrs["kernel"] == "cuda"
    a, b = pred.run(feed), loaded.run(feed)
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_the_torch_impl_is_still_refused_by_predictor():
    with pytest.raises(ValueError, match="generate_proposals.*'torch'"):
        Predictor(_graph("torch"), device="cpu")


def _sorted_candidates(rng, g, k):
    c = rng.uniform(0, 60, (g, k, 2))
    wh = rng.uniform(4, 30, (g, k, 2))
    boxes = np.concatenate([c, c + wh], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (g, k)).astype(np.float32), axis=1)
    scores[:, -k // 5:] = 0.0  # invalid tail, as min_size leaves it
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.parametrize("iou_t", [0.3, 0.7])
def test_division_form_is_nms_single_class(iou_t):
    """On score-sorted candidates (beats(j, i) is j < i for valid pairs) the
    division form's kept scores are nms_single_class's; the zeros are made
    +0.0 as the "cuda" impl makes them."""
    b, s = _sorted_candidates(np.random.default_rng(7), 3, 200)
    got = p_nms.nms_keep_scores_plain(b, s, iou_t=iou_t, score_t=0.0, iou_form="div")
    got = torch.where(got > 0, got, got.new_zeros(()))
    want = p_det.nms_single_class(b, s, iou_t, 0.0)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ref, _, _ = jax.vmap(lambda bb, ss: r_det._nms_single_class(bb, ss, iou_t, 0.0, 200))(
        jax.numpy.asarray(b.numpy()), jax.numpy.asarray(s.numpy()))
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(ref)))


def _split_pair():
    """Boxes b = [0, 0, w2, h] and a = [0, 0, w1, h] inside it, w2 ≈ w1 / 0.7,
    whose IoU test rounds apart in fp32 at t = 0.7: inter / max(union,
    1e-10) > t, but not inter > t·union (a seeded search)."""
    f, t = np.float32, np.float32(0.7)
    rng = np.random.default_rng(0)
    w1 = rng.uniform(1, 100, 100_000).astype(f)
    h = rng.uniform(1, 100, 100_000).astype(f)
    w2 = (w1 / t).astype(f)
    w2 = (w2 + rng.integers(-3, 4, w2.shape).astype(f) * np.spacing(w2)).astype(f)
    inter = (w1 * h).astype(f)
    union = ((w2 * h).astype(f) + inter).astype(f) - inter
    div = (inter / np.maximum(union, f(1e-10))).astype(f) > t
    mul = inter > (t * union).astype(f)
    i = int(np.flatnonzero(div & ~mul)[0])
    return [0.0, 0.0, float(w2[i]), float(h[i])], [0.0, 0.0, float(w1[i]), float(h[i])]


def test_the_forms_round_apart_and_div_follows_the_reference():
    b, a = _split_pair()
    boxes = torch.tensor([[b, a]], dtype=torch.float32)
    scores = torch.tensor([[0.9, 0.8]], dtype=torch.float32)
    kw = dict(iou_t=0.7, score_t=0.0)
    div = p_nms.nms_keep_scores_plain(boxes, scores, iou_form="div", **kw)
    mul = p_nms.nms_keep_scores_plain(boxes, scores, iou_form="mul", **kw)
    single = p_det.nms_single_class(boxes, scores, 0.7, 0.0)
    ref, _, _ = r_det._nms_single_class(jax.numpy.asarray(boxes[0].numpy()),
                                        jax.numpy.asarray(scores[0].numpy()), 0.7, 0.0, 2)
    assert div.tolist() == [[pytest.approx(0.9), 0.0]]  # b suppresses a by division
    assert mul.tolist() == [[pytest.approx(0.9), pytest.approx(0.8)]]  # not by product
    np.testing.assert_array_equal(_bits(div[0]), _bits(np.asarray(ref)))
    np.testing.assert_array_equal(_bits(single[0]), _bits(np.asarray(ref)))


def test_iou_form_is_checked():
    b, s = _sorted_candidates(np.random.default_rng(1), 1, 8)
    with pytest.raises(ValueError, match="iou_form"):
        p_nms.nms_keep_scores(b, s, iou_t=0.5, score_t=0.0, iou_form="ratio")
