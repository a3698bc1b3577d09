"""The port's twins of the four ``examples/`` (``examples/torch_*.py``) on
the CPU, at the tiny sizes of ``tests/test_examples.py``, against the
reference examples.

- The classifier: the twin's preprocessing is the reference's, byte for
  byte (NV12 → RGB → resize → to_tensor), and its int8 predictor's softmax
  on those frames within atol 1e-3 of the reference's (the main path's
  bound, ``tests/test_torch_main_path.py``); the twin serves through the
  port's batcher.
- SSD detection and the OCR pipeline: the host-side glue of each twin
  (preprocess, the run, the NMS rows / DB boxes, crops and CTC decode)
  gives the reference's results on the same predictor outputs: both are
  driven over the twin's predictors (the reference's through numpy copies
  of their outputs), and the whole twin runs end to end.
- OCR strips: the twin's length bucketer pads as the reference's does
  (its stats) and decodes every strip as the reference's server does.
- The twins, ``cv``, the kernel table and ``cli`` import no jax.
"""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

_EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
SOFTMAX_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, _EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Numpy:
    """A port predictor seen as the reference examples see a predictor:
    its outputs as numpy arrays; the feeds it got are kept."""

    def __init__(self, pred):
        self.pred, self.feeds = pred, []
        self.output_names = pred.output_names

    def input_shape(self, name):
        return self.pred.input_shape(name)

    def run(self, feed):
        self.feeds.append({k: np.array(v) for k, v in feed.items()})
        return {k: v.cpu().numpy() for k, v in self.pred.run(feed).items()}


class _Recorded(_Numpy):
    """The same, its outputs left as tensors (the twins' view)."""

    def run(self, feed):
        self.feeds.append({k: np.array(v) for k, v in feed.items()})
        return self.pred.run(feed)


def _feeds_equal(a, b):
    assert len(a.feeds) == len(b.feeds)
    for fa, fb in zip(a.feeds, b.feeds):
        assert fa.keys() == fb.keys()
        assert all(fa[k].tobytes() == fb[k].tobytes() for k in fa)


def test_serve_classifier_twin(monkeypatch):
    ref, twin = _load("serve_classifier"), _load("torch_serve_classifier")
    size, (h, w) = 32, (48, 64)
    monkeypatch.setattr(ref, "IMAGE_SIZE", size)
    frames = [twin.nv12_frame(h, w, seed=i) for i in range(2)]
    x = np.stack([twin.preprocess(y, uv, h, w, size) for y, uv in frames])
    assert x.tobytes() == np.stack([ref.preprocess(y, uv, h, w) for y, uv in frames]).tobytes()
    pred, rpred = twin.make_predictor(1, size, device="cpu"), ref.make_predictor(1)
    for xi in x:
        got = next(iter(pred.run({"image": xi[None]}).values())).numpy()
        want = np.asarray(next(iter(rpred.run({"image": xi[None]}).values())))
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
    tops = twin.main(device="cpu", clients=3, buckets=(1, 2, 4), frame=(h, w),
                     image_size=size)
    assert len(tops) == 3 and all(len(t) == 5 and all(0 <= c < 1000 for c in t)
                                  for t in tops)


def test_detect_ssd_twin():
    ref, twin = _load("detect_ssd"), _load("torch_detect_ssd")
    pred = twin.make_predictor(image_size=150, device="cpu")
    image = np.random.default_rng(0).integers(0, 255, (240, 320, 3)).astype(np.uint8)
    mine, theirs = _Recorded(pred), _Numpy(pred)
    got = twin.detect(mine, image, score_thresh=0.0)
    assert got == ref.detect(theirs, image, score_thresh=0.0)
    _feeds_equal(mine, theirs)
    assert got and all(0.0 <= s <= 1.0 and isinstance(n, str) for n, s, _ in got)


class _Det:
    """A DB head's probability map with three text lines, as a predictor."""

    output_names = ["prob"]

    def __init__(self, size, as_numpy):
        self.size, self.as_numpy, self.feeds = size, as_numpy, []

    def input_shape(self, name):
        return (1, self.size, self.size, 3)

    def run(self, feed):
        self.feeds.append({k: np.array(v) for k, v in feed.items()})
        p = np.zeros((1, self.size, self.size, 1), np.float32)
        for y0, x0, x1 in ((20, 10, 120), (60, 30, 150), (110, 5, 90)):
            p[0, y0:y0 + 12, x0:x1] = 0.9
        return {"prob": p if self.as_numpy else torch.from_numpy(p)}


def _boxes(results):
    return [((b.x1, b.y1, b.x2, b.y2, b.score), text) for b, text in results]


def test_ocr_pipeline_twin():
    ref, twin = _load("ocr_pipeline"), _load("torch_ocr_pipeline")
    det, rec = twin.make_pipeline(det_size=160, rec_width=64, rec_batch=2, hidden=16,
                                  device="cpu")
    image = twin.synthetic_document(320, 480, n_lines=3)
    assert image.tobytes() == ref.synthetic_document(320, 480, n_lines=3).tobytes()
    mine = (_Det(160, False), _Recorded(rec))
    theirs = (_Det(160, True), _Numpy(rec))
    got = twin.recognize(*mine, image, max_boxes=2)
    assert len(got) == 2
    assert _boxes(got) == _boxes(ref.recognize(*theirs, image, max_boxes=2))
    for a, b in zip(mine, theirs):
        _feeds_equal(a, b)
    for box, text in twin.recognize(det, rec, image, max_boxes=2):
        assert box.x2 >= box.x1 and box.y2 >= box.y1 and isinstance(text, str)


def test_serve_ocr_strips_twin():
    ref, twin = _load("serve_ocr_strips"), _load("torch_serve_ocr_strips")
    kw = dict(width_buckets=(32, 64), num_chars=10, hidden=16)
    rng = np.random.default_rng(0)
    strips = [rng.normal(size=(twin.HEIGHT, w, 3)).astype(np.float32) for w in (20, 40, 60)]
    texts = {}
    for name, mod, extra in (("twin", twin, {"device": "cpu"}), ("ref", ref, {})):
        server = mod.make_server(**kw, **extra)
        try:
            texts[name] = [mod.decode(f.result(timeout=300))
                           for f in [server.submit({"image": s}) for s in strips]]
            assert server.stats["requests"] == 3
            assert server.stats["padded_tokens"] == (32 - 20) + (64 - 40) + (64 - 60)
        finally:
            server.close()
    assert texts["twin"] == texts["ref"]


def test_the_twins_and_the_new_modules_import_no_jax():
    """The twins, ``cv``, the kernel table and ``cli`` import neither jax
    nor the JAX package."""
    twins = [str(p) for p in sorted(_EXAMPLES.glob("torch_*.py"))]
    code = (
        "import importlib.util, sys\n"
        "import paddle_lite_tpu_torch.cv, paddle_lite_tpu_torch.tools.cli\n"
        "import paddle_lite_tpu_torch.ops.kernels.tune_cache\n"
        "import paddle_lite_tpu_torch.ops.kernels.autotune\n"
        f"for path in {twins!r}:\n"
        "    spec = importlib.util.spec_from_file_location('twin', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(repr([m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "            or m == 'paddle_lite_tpu' or m.startswith('paddle_lite_tpu.')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_EXAMPLES.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
