"""The serving stack of the port: the continuous batcher over compiled
predictors, the batch table, batch_tune and the benchmark tool, held to the
reference's ``runtime/batcher.py`` contract (its tests/test_batcher.py
cases, ported) and to the reference's batcher on the same requests.

Three faults of the reference's batch table are not copied; each has a
test here that asserts the corrected behaviour (and shows the reference's).

Tolerances: a request's output through the batcher against the same
predictor run directly on batch 1, and the two packages' batchers against
each other: fp32 graphs, so rtol 1e-4 / atol 1e-5 (the bound of the
reference's test; sums of another batch size or of XLA run in another
order).
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.formats import artifact
from paddle_lite_tpu.runtime import batch_table as r_table
from paddle_lite_tpu.runtime.batcher import BatcherConfig as RConfig
from paddle_lite_tpu.runtime.batcher import ContinuousBatcher as RBatcher
from paddle_lite_tpu.runtime.predictor import create_predictor as r_create
from paddle_lite_tpu_torch.formats.interop import graph_from_reference
from paddle_lite_tpu_torch.runtime import batch_table
from paddle_lite_tpu_torch.runtime.batcher import BatcherConfig, ContinuousBatcher
from paddle_lite_tpu_torch.runtime.predictor import create_predictor
from paddle_lite_tpu_torch.tools import batch_tune, benchmark

RTOL, ATOL = 1e-4, 1e-5


def _graph(builder, bucket: int):
    b = builder("m", seed=41)
    x = b.input("x", (bucket, 4, 4, 8))
    y = b.conv_bn_act(x, 16, 1, act="relu")
    y = b.pool2d(y, "avg", global_pooling=True)
    y = b.reshape(y, (bucket, 16))
    y = b.fc(y, 4)
    b.mark_output(y)
    return b.build()


def _factory(bucket: int):
    # fp32: per-bucket PTQ would calibrate each bucket on other data
    return create_predictor(_graph(P.GraphBuilder, bucket), device="cpu")


def _close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_batcher_matches_direct(rng):
    batcher = ContinuousBatcher(_factory, BatcherConfig(buckets=(1, 2, 4), max_wait_ms=5))
    try:
        xs = [rng.normal(size=(4, 4, 8)).astype(np.float32) for _ in range(6)]
        futs = [batcher.submit({"x": x}) for x in xs]
        outs = [f.result(timeout=60) for f in futs]
        direct = _factory(1)
        for x, out in zip(xs, outs):
            ref = direct.run({"x": x[None]})
            k = list(ref)[0]
            assert isinstance(out[k], torch.Tensor) and out[k].shape == (4,)
            _close(out[k], ref[k][0])
        assert batcher.stats["requests"] == 6
        assert batcher.stats["batches"] <= 6
    finally:
        batcher.close()


def test_batcher_results_are_fresh(rng):
    """A request's result is a slice of its batch's own output tensor: the
    batches after it do not change it."""
    batcher = ContinuousBatcher(_factory, BatcherConfig(buckets=(2,), max_wait_ms=1))
    try:
        xs = [rng.normal(size=(4, 4, 8)).astype(np.float32) for _ in range(8)]
        first = batcher.infer({"x": xs[0]}, timeout=60)
        kept = {k: v.clone() for k, v in first.items()}
        for x in xs[1:]:
            batcher.infer({"x": x}, timeout=60)
        assert all(torch.equal(first[k], kept[k]) for k in kept)
    finally:
        batcher.close()


def test_batcher_groups_concurrent_requests(rng):
    calls = []

    def counting_factory(bucket):
        pred = _factory(bucket)

        class Wrap:
            def run(self, inputs):
                calls.append(inputs[list(inputs)[0]].shape[0])
                return pred.run(inputs)

        return Wrap()

    batcher = ContinuousBatcher(counting_factory,
                                BatcherConfig(buckets=(1, 2, 4), max_wait_ms=200))
    try:
        xs = [rng.normal(size=(4, 4, 8)).astype(np.float32) for _ in range(4)]
        futs = [batcher.submit({"x": x}) for x in xs]
        for f in futs:
            f.result(timeout=120)
        assert len(calls) <= 2, calls
    finally:
        batcher.close()


def test_batcher_failure_isolated(rng):
    """A failing batch fails its own futures only; the next batch runs."""
    state = {"fail": True}

    def factory(bucket):
        pred = _factory(bucket)

        class Flaky:
            def run(self, inputs):
                if state["fail"]:
                    raise RuntimeError("device on fire")
                return pred.run(inputs)

        return Flaky()

    batcher = ContinuousBatcher(factory, BatcherConfig(buckets=(1, 2)))
    try:
        f = batcher.submit({"x": np.zeros((4, 4, 8), np.float32)})
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=30)
        f2 = batcher.submit({"x": np.zeros((4, 4, 8), np.float32)})
        with pytest.raises(RuntimeError):
            f2.result(timeout=30)
        state["fail"] = False
        x = rng.normal(size=(4, 4, 8)).astype(np.float32)
        out = batcher.infer({"x": x}, timeout=60)
        ref = _factory(1).run({"x": x[None]})
        k = list(ref)[0]
        _close(out[k], ref[k][0])
    finally:
        batcher.close()


class _Echo:
    def __init__(self, batch):
        self.batch = batch

    def run(self, inputs):
        assert inputs["x"].shape[0] == self.batch
        return {"out": torch.from_numpy(inputs["x"] * 2)}


def _rows(d, model, rows):
    batch_table.save_rows(model, rows, card="test card", power_limit="1.00 W",
                          table_dir=d)


def test_model_bucket_cap(tmp_path):
    """A measured table caps the ladder at the model's best batch."""
    d = str(tmp_path)
    _rows(d, "dbnet_like", {1: 300.0, 2: 500.0, 4: 900.0, 8: 700.0, 16: 650.0})
    assert batch_table.best_bucket(batch_table.load_entry("dbnet_like", d),
                                   (1, 2, 4, 8, 16)) == 4
    built = []
    cfg = BatcherConfig(buckets=(1, 2, 4, 8, 16), model="dbnet_like", table_dir=d,
                        max_wait_ms=20.0)
    b = ContinuousBatcher(lambda bb: built.append(bb) or _Echo(bb), cfg)
    try:
        assert tuple(b.config.buckets) == (1, 2, 4)
        futs = [b.submit({"x": np.full((3,), i, np.float32)}) for i in range(10)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=10)["out"], np.full((3,), 2 * i))
        assert max(built) <= 4
    finally:
        b.close()
    b2 = ContinuousBatcher(_Echo, BatcherConfig(buckets=(1, 2, 4, 8, 16),
                                                model="never_measured", table_dir=d))
    try:
        assert tuple(b2.config.buckets) == (1, 2, 4, 8, 16)
    finally:
        b2.close()


def test_cliff_aware_bucket_dispatch(tmp_path):
    """n requests go to the measured-fastest bucket >= n, which can be
    larger than the smallest fit."""
    d = str(tmp_path)
    _rows(d, "mnv3_like", {2: 3322.7, 4: 3580.8, 8: 9215.9, 64: 35680.3})
    entry = batch_table.load_entry("mnv3_like", d)
    ladder = (1, 2, 4, 8, 16, 32, 64)
    assert batch_table.bucket_for(entry, 3, ladder) == 8
    assert batch_table.bucket_for(entry, 1, ladder) == 2
    assert batch_table.bucket_for({}, 3, (1, 2, 4)) is None
    built = []
    b = ContinuousBatcher(lambda bb: built.append(bb) or _Echo(bb),
                          BatcherConfig(buckets=ladder, model="mnv3_like", table_dir=d,
                                        max_wait_ms=30.0))
    try:
        futs = [b.submit({"x": np.full((2,), i, np.float32)}) for i in range(3)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=10)["out"], np.full((2,), 2 * i))
        assert 8 in built and 4 not in built
    finally:
        b.close()


# ---- the three reference faults, corrected -------------------------------

def test_table_is_read_once_when_the_batcher_is_built(tmp_path, monkeypatch):
    """The reference re-reads the table from disk on every dispatched batch
    (batcher.py:111 -> batch_table.py:77); the port reads it once."""
    d = str(tmp_path)
    _rows(d, "m", {2: 100.0, 8: 1000.0})
    reads = []
    real = batch_table.load_table
    monkeypatch.setattr(batch_table, "load_table",
                        lambda *a, **kw: reads.append(1) or real(*a, **kw))
    built = []
    b = ContinuousBatcher(lambda bb: built.append(bb) or _Echo(bb),
                          BatcherConfig(buckets=(1, 2, 4, 8), model="m", table_dir=d,
                                        max_wait_ms=1.0))
    try:
        assert len(reads) == 1
        _rows(d, "m", {2: 1e9})  # a later write does not reach this batcher
        n = len(reads)
        for i in range(5):
            assert b.infer({"x": np.full((2,), i, np.float32)}, timeout=10)["out"][0] == 2 * i
        assert len(reads) == n and built == [8]
    finally:
        b.close()


def test_best_bucket_keeps_to_the_ladder_cap(tmp_path):
    """A batch measured above the ladder's largest bucket is not the
    batcher's best; the reference returns it (batch_table.py:58-61)."""
    d = str(tmp_path)
    rows = {4: 500.0, 16: 900.0, 128: 2000.0}
    _rows(d, "m", rows)
    ladder = (1, 2, 4, 8, 16, 32)
    assert batch_table.best_bucket(batch_table.load_entry("m", d), ladder) == 16
    rd = str(tmp_path / "reference")
    r_table.save_entry("m", rows, rd)
    assert r_table.best_bucket("m", ladder, rd) == 128  # the reference's fault
    b = ContinuousBatcher(_Echo, BatcherConfig(buckets=ladder, model="m", table_dir=d))
    try:
        assert tuple(b.config.buckets) == (1, 2, 4, 8, 16)
    finally:
        b.close()


def test_zero_or_negative_entry_is_unmeasured(tmp_path):
    """A zero, negative or non-finite items/s is an unmeasured row; the
    reference divides by it (batch_table.py:80)."""
    d = str(tmp_path)
    _rows(d, "m", {2: 0.0, 4: -5.0, 8: float("nan"), 16: 400.0})
    entry = batch_table.load_entry("m", d)
    assert entry == {16: 400.0}
    assert batch_table.bucket_for(entry, 1, (1, 2, 4, 8, 16)) == 16
    assert batch_table.best_bucket(entry, (1, 2, 4, 8, 16)) == 16
    rd = str(tmp_path / "reference")
    r_table.save_entry("m", {2: 0.0, 16: 400.0}, rd)
    with pytest.raises(ZeroDivisionError):  # the reference's fault
        r_table.bucket_for("m", 1, (1, 2, 4, 8, 16), rd)


def test_table_lives_in_the_port_not_autotune(tmp_path):
    d = batch_table.DEFAULT_DIR
    assert d.parent.name == "paddle_lite_tpu_torch" and ".autotune" not in d.parts
    _rows(str(tmp_path), "m", {4: 10.0})
    row = json.loads((tmp_path / "batch.json").read_text())["m"]["4"]
    assert row == {"items_per_s": 10.0, "card": "test card", "power_limit": "1.00 W"}


# ---- both packages on the same requests ----------------------------------

def test_both_packages_batchers_agree(rng):
    graphs = {b: _graph(R.GraphBuilder, b) for b in (1, 2, 4)}

    def r_factory(bucket):
        return r_create(graphs[bucket], optimize=True)

    def p_factory(bucket):
        g = graphs[bucket]
        return create_predictor(graph_from_reference(artifact.graph_to_meta(g), g.weights),
                                optimize=False, device="cpu")

    xs = [rng.normal(size=(4, 4, 8)).astype(np.float32) for _ in range(7)]
    outs = {}
    for name, mk, fac in (("ref", (RBatcher, RConfig), r_factory),
                          ("port", (ContinuousBatcher, BatcherConfig), p_factory)):
        b = mk[0](fac, mk[1](buckets=(1, 2, 4), max_wait_ms=20.0))
        try:
            futs = [b.submit({"x": x}) for x in xs]
            outs[name] = [f.result(timeout=120) for f in futs]
        finally:
            b.close()
    for r, p in zip(outs["ref"], outs["port"]):
        assert set(r) == set(p)
        for k in r:
            _close(p[k], np.asarray(r[k]))


def test_clients_on_threads_get_their_own_results(rng):
    """8 client threads through one batcher: every result is its own
    request's (the direct batch-1 run of the same input)."""
    direct = _factory(1)
    xs = [rng.normal(size=(4, 4, 8)).astype(np.float32) for _ in range(48)]
    got = [None] * len(xs)
    batcher = ContinuousBatcher(_factory, BatcherConfig(buckets=(1, 2, 4, 8), max_wait_ms=2))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(c):
            for i in range(c, len(xs), 8):
                got[i] = batcher.infer({"x": xs[i]}, timeout=60)

        ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        batcher.close()
    assert batcher.stats["requests"] == len(xs)
    for x, out in zip(xs, got):
        ref = direct.run({"x": x[None]})
        k = list(ref)[0]
        _close(out[k], ref[k][0])


# ---- tools -----------------------------------------------------------------

def test_batch_tune_merges_rows(tmp_path, monkeypatch):
    d = str(tmp_path)
    _rows(d, "m", {4: 100.0, 8: 50.0, 16: 200.0})

    def fake_bench(model, *, batch, **kw):
        return {"int8_items_per_sec": 999.0 + batch}

    monkeypatch.setattr(benchmark, "bench_model", fake_bench)
    monkeypatch.setattr(sys, "argv", ["batch_tune", "--model", "m", "--buckets", "8",
                                      "--table-dir", d, "--device", "cpu"])
    batch_tune.main()
    assert batch_table.load_entry("m", d) == {4: 100.0, 8: 1007.0, 16: 200.0}
    rows = batch_table.load_table(d)["m"]
    assert rows["8"]["card"] == "cpu" and rows["4"]["card"] == "test card"


def test_bench_model_returns_the_reference_keys():
    from paddle_lite_tpu.tools.benchmark import bench_model as r_bench

    kw = dict(batch=1, image_size=32, with_fp32=True, method="dispatch")
    want = r_bench("mobilenet_v1", **kw)
    got = benchmark.bench_model("mobilenet_v1", device="cpu", **kw)
    assert set(want) <= set(got) and set(got) - set(want) == {"device"}
    assert got["device"] == {"name": "cpu", "power_limit": None}
    assert {k: got[k] for k in ("model", "batch", "method")} == \
        {k: want[k] for k in ("model", "batch", "method")}
    assert got["int8_items_per_sec"] > 0 and got["fp32_items_per_sec"] > 0


def test_bench_model_loop_method_on_the_cpu():
    got = benchmark.bench_model("mobilenet_v1", batch=1, image_size=32, device="cpu")
    assert got["method"] == "loop" and got["int8_items_per_sec"] > 0


@pytest.mark.parametrize("call", [
    lambda: benchmark.resolve_builder("ernie_tiny"),
    lambda: benchmark.bench_model("ernie_tiny", batch=1, device="cpu"),
    lambda: benchmark.bench_model("ernie_tiny", batch=1, method="dispatch", device="cpu"),
    lambda: benchmark.bench_model("ernie_tiny", batch=1, zoo_config=False, device="cpu"),
], ids=["resolve_builder", "loop", "dispatch", "no_zoo_config"])
def test_unported_model_raises(call):
    """ERNIE-tiny, the one zoo model not ported yet, raises through every
    entry of the benchmark tool; an unknown name is a ValueError."""
    with pytest.raises(NotImplementedError, match="ernie_tiny"):
        call()
    with pytest.raises(ValueError, match="unknown model"):
        benchmark.resolve_builder("no_such_model")


@pytest.mark.parametrize("model,size,shape", [
    ("ppocr_det", None, (1, 640, 640, 3)), ("dbnet", 64, (1, 64, 64, 3)),
    ("ppocr_rec", None, (1, 32, 320, 3)), ("crnn", 64, (1, 32, 64, 3)),
    ("ppocr_rec_long", None, (1, 32, 1600, 3)), ("crnn_long", 160, (1, 32, 160, 3)),
])
def test_ported_models_resolve(model, size, shape):
    """The six PP-OCR names build as the reference's benchmark builds them:
    DBNet at 640 px, CRNN at strip width 320, the long strip at 1600 with
    hidden 64."""
    g = benchmark.resolve_builder(model)(batch=1, image_size=size)
    assert g.vars[g.inputs[0]].shape == shape
    if model.endswith("_long"):
        w = next(n for n in g.weights if n.endswith("fw.w_hh"))
        assert g.weights[w].shape == (64, 192)
