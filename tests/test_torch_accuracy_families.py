"""The accuracy families and the eval harness of the port, held to the JAX
package on the CPU.

- The helpers (``_iou_xyxy``, ``match_detections``, ``_edit_distance``,
  ``_decode_rows``): ``tests/test_accuracy_families.py``'s cases, run against
  both packages as one parametrised test.
- Each of the four reports at a tiny size (SSD 96 px / 1 image, DBNet 64 px
  / 2 images, CRNN width 32 / 4 strips, ERNIE-tiny hidden 64 / 2 layers /
  len 8 / 4 sequences, the same seed) compared field by field with the
  reference's: strings and counts equal; every rate, IoU and cosine
  (rounded to 4-6 digits by the reports) equal within 1e-6, and within
  2e-3 in a variant with bf16 islands, where the two packages round to
  bf16 at other points (ERNIE's top-probability drift read 0.0060 against
  0.0054 there).  DBNet's ``int8_recommended`` variant is the zoo entry of
  the package that runs it, so the reference runs it here with the port's
  entry (measured on the card: the defaults).  Each reference report runs
  here on the same inputs; the
  reference's SSD report compiles 21 programs (about 45 s on the CPU,
  nearly all of it XLA's compiles, so a smaller image would not shorten
  it).
- ``eval``: ``evaluate`` and ``top1_delta`` on the same graph and data
  through both packages' predictors equal.
"""

import functools

import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu.tools import accuracy_families as r_af
from paddle_lite_tpu.tools import eval as r_eval
from paddle_lite_tpu_torch.formats import interop
from paddle_lite_tpu_torch.tools import accuracy_families as p_af
from paddle_lite_tpu_torch.tools import eval as p_eval

PKGS = {"reference": r_af, "port": p_af}
FLOAT_TOL, BF16_TOL = 1e-6, 2e-3



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores,
    and PyTorch's default of one thread a core each oversubscribes them
    (a timing test here then ran for minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(dets):
    """[(label, score, x1, y1, x2, y2), ...] -> (k, 6) padded to 10."""
    out = np.full((10, 6), -1.0, np.float32)
    out[:, 1:] = 0.0
    for i, d in enumerate(dets):
        out[i] = d
    return out


def _iou_matrix(af):
    a = np.array([[0, 0, 10, 10]], np.float64)
    b = np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]], np.float64)
    iou = af._iou_xyxy(a, b)[0]
    assert abs(iou[0] - 1.0) < 1e-9 and abs(iou[1] - 25 / 175) < 1e-9 and iou[2] == 0.0


def _match_basic(af):
    ref = _rows([(1, 0.9, 0, 0, 10, 10), (2, 0.8, 20, 20, 30, 30)])
    got = _rows([(1, 0.85, 1, 1, 10, 10), (2, 0.7, 21, 21, 30, 30)])
    assert af.match_detections(ref, got, conf=0.5) == {"matched": 2, "ref": 2, "got": 2}


def _label_flip(af):
    ref = _rows([(1, 0.9, 0, 0, 10, 10)])
    got = _rows([(3, 0.9, 0, 0, 10, 10)])
    assert af.match_detections(ref, got, conf=0.5)["matched"] == 0
    assert af.match_detections(ref, got, conf=0.5, same_label=False)["matched"] == 1


def _threshold_robust(af):
    m = af.match_detections(_rows([(1, 0.30, 0, 0, 10, 10)]),
                            _rows([(1, 0.26, 0, 0, 10, 10)]), conf=0.29)
    assert m["matched"] == 1 and m["got"] == 0


def _edit_distance(af):
    assert af._edit_distance([], []) == 0
    assert af._edit_distance([1, 2, 3], [1, 2, 3]) == 0
    assert af._edit_distance([1, 2, 3], [1, 3]) == 1
    assert af._edit_distance([1, 2], [2, 1]) == 2
    assert af._edit_distance([], [5, 6]) == 2


def _decode_rows(af):
    assert af._decode_rows(np.array([[3, 1, -1, -1], [-1, -1, -1, -1]])) == [[3, 1], []]


HELPERS = {f.__name__.lstrip("_"): f for f in (
    _iou_matrix, _match_basic, _label_flip, _threshold_robust, _edit_distance, _decode_rows)}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(HELPERS))
def test_helper(case, pkg):
    HELPERS[case](PKGS[pkg])


def _same(got, want, tol, path=""):
    """Field-by-field comparison of two reports."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], BF16_TOL if "bf16" in str(k) else tol, f"{path}/{k}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=tol), path
    else:
        assert got == want, path


SIZES = {"ssd": dict(n_images=1, batch=1, image_size=96),
         "dbnet": dict(n_images=2, batch=1, image_size=64),
         "crnn": dict(n_images=4, batch=2, width=32),
         "ernie": dict(n_seqs=4, batch=2, seq_len=8)}


@pytest.mark.parametrize("family", sorted(SIZES))
def test_report_matches_the_reference(family, monkeypatch):
    if family == "ernie":  # the full vocabulary (the token draw's), narrow layers
        import paddle_lite_tpu.models.ernie_tiny as r_ernie
        import paddle_lite_tpu_torch.models.ernie_tiny as p_ernie

        small = dict(hidden=64, n_layers=2, n_heads=4, ffn_dim=128)
        monkeypatch.setattr(r_ernie, "build", functools.partial(r_ernie.build, **small))
        monkeypatch.setattr(p_ernie, "build", functools.partial(p_ernie.build, **small))
    if family == "dbnet":  # "int8_recommended" is each package's zoo entry: the port's
        import paddle_lite_tpu.models.zoo_config as r_zoo
        import paddle_lite_tpu_torch.models.zoo_config as p_zoo

        monkeypatch.setitem(r_zoo.RECOMMENDED, "ppocr_det", p_zoo.RECOMMENDED["ppocr_det"])
    got = p_af.FAMILIES[family](device="cpu", **SIZES[family])
    want = r_af.FAMILIES[family](**SIZES[family])
    _same(got, want, FLOAT_TOL)
    assert got["variants"]


def _eval_model(pkg):
    b = pkg.GraphBuilder("m", seed=101)
    x = b.input("x", (4, 8, 8, 8))
    y = b.conv_bn_act(x, 16, 3, padding=1, act="relu")
    y = b.pool2d(y, "avg", global_pooling=True)
    b.mark_output(b.fc(b.reshape(y, (4, 16)), 10))
    return b.build()


def test_top1_delta_matches_the_reference():
    """tests/test_eval.py's model and data through both packages: the int8
    graph optimized by the reference and carried across, so both predictors
    run the same scales."""
    from paddle_lite_tpu.runtime.predictor import Predictor as RPredictor
    from paddle_lite_tpu.runtime.predictor import create_predictor as r_create
    from paddle_lite_tpu_torch.runtime.predictor import Predictor

    data = list(r_eval.synthetic_dataset("x", (4, 8, 8, 8), 10, batches=3))
    assert all(np.array_equal(a[0]["x"], b[0]["x"]) and np.array_equal(a[1], b[1]) for a, b in
               zip(data, p_eval.synthetic_dataset("x", (4, 8, 8, 8), 10, batches=3)))
    r8 = r_create(_eval_model(R), quant=R.QuantConfig(),
                  calib_batches=[inputs for inputs, _ in data[:2]])
    g8 = interop.graph_from_reference(r_artifact.graph_to_meta(r8.graph), r8.graph.weights)
    want = r_eval.top1_delta(RPredictor(_eval_model(R)), r8, data)
    got = p_eval.top1_delta(Predictor(_eval_model(P), device="cpu"),
                            Predictor(g8, device="cpu"), data)
    assert got == pytest.approx(want, abs=1e-12)
    res, ref = p_eval.evaluate(Predictor(g8, device="cpu"), data), r_eval.evaluate(r8, data)
    assert (res.top1, res.top5, res.n) == (ref.top1, ref.top5, ref.n) and res.n == 12
