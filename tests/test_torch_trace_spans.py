"""The program's own spans and counters (``core/trace.py``) on the CPU: no
``record_function`` while no profiler records and no count on the request
path, the request path's spans nested under the profiler, the set-up
totals of ``create_predictor``, the batcher's queue wait, and the counters
under threads."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_lite_tpu_torch as P
from paddle_lite_tpu_torch.core import trace
from paddle_lite_tpu_torch.ops.kernels import _build
from paddle_lite_tpu_torch.runtime.batcher import BatcherConfig, ContinuousBatcher
from paddle_lite_tpu_torch.runtime.predictor import create_predictor
from paddle_lite_tpu_torch.tools import trace as trace_tool

REQUEST_SPANS = ("plt.predictor.validate", "plt.predictor.stage_inputs",
                 "plt.graph.replay", "plt.predictor.clone_outputs")


@pytest.fixture(autouse=True)
def fresh_totals():
    trace.reset()
    yield
    trace.reset()


def _graph(batch: int = 2):
    b = P.GraphBuilder("m", seed=7)
    x = b.input("x", (batch, 6, 6, 4))
    y = b.conv_bn_act(x, 8, 3, act="relu")
    y = b.pool2d(y, "avg", global_pooling=True)
    y = b.reshape(y, (batch, 8))
    y = b.fc(y, 3)
    b.mark_output(y)
    return b.build()


def _feed(seed: int, batch: int = 2):
    x = np.random.default_rng(seed).normal(size=(batch, 6, 6, 4)).astype(np.float32)
    return {"x": x}


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith(trace.PREFIX)]


def test_no_record_function_while_no_profiler_records(monkeypatch):
    pred = create_predictor(_graph(), device="cpu")

    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    assert trace.span("predictor.run") is trace.span("graph.replay")
    pred.run(_feed(0))
    pred.run(_feed(1))


def test_request_spans_nest_under_the_profiler():
    pred = create_predictor(_graph(), device="cpu")
    feed = _feed(0)
    pred.run(feed)
    events = _profiled(lambda: pred.run(feed))
    runs = [e for e in events if e.name == "plt.predictor.run"]
    assert len(runs) == 1
    outer = runs[0].time_range
    inner = {e.name: e.time_range for e in events if e.name in REQUEST_SPANS}
    assert set(inner) == set(REQUEST_SPANS)
    for name, r in inner.items():
        assert outer.start <= r.start and r.end <= outer.end, name
    starts = [inner[n].start for n in REQUEST_SPANS]
    assert starts == sorted(starts)  # validate, stage, replay, clone in turn
    for a, b in zip(REQUEST_SPANS, REQUEST_SPANS[1:]):
        assert inner[a].end <= inner[b].start, (a, b)


def test_the_request_path_counts_nothing():
    pred = create_predictor(_graph(), device="cpu")
    trace.reset()  # what building the predictor counted
    pred.run(_feed(0))
    _profiled(lambda: pred.run(_feed(1)))
    pred.run({"x": torch.from_numpy(_feed(2)["x"])})
    assert trace.snapshot() == {"totals": {}, "counters": {}}


def test_create_predictor_with_ptq_adds_setup_totals():
    calib = [_feed(s) for s in range(3)]
    events = _profiled(lambda: create_predictor(
        _graph(), quant=P.QuantConfig(), calib_batches=calib, device="cpu"))
    totals = trace.snapshot()["totals"]
    assert totals["setup.calibrate"][1] == 1 and totals["setup.calibrate"][0] > 0
    assert totals["setup.optimize"][1] == 1
    assert totals["setup.stage_weights"][1] == 2  # calibration's and the predictor's
    (cal,) = [e.time_range for e in events if e.name == "plt.setup.calibrate"]
    (opt,) = [e.time_range for e in events if e.name == "plt.setup.optimize"]
    assert opt.start <= cal.start and cal.end <= opt.end  # and left out of its seconds


def test_setup_span_counts_a_failed_entry_too():
    with pytest.raises(ValueError):
        with trace.setup_span("setup.x"):
            raise ValueError("boom")
    with trace.setup_span("setup.x"):
        time.sleep(0.01)
    secs, n = trace.snapshot()["totals"]["setup.x"]
    assert n == 2 and secs >= 0.01


def test_setup_totals_are_self_time():
    t0 = time.perf_counter()
    with trace.setup_span("setup.outer"):
        time.sleep(0.02)
        with trace.setup_span("setup.inner"):
            time.sleep(0.05)
    whole = time.perf_counter() - t0
    totals = trace.snapshot()["totals"]
    inner, outer = totals["setup.inner"][0], totals["setup.outer"][0]
    assert inner >= 0.05 and outer >= 0.02
    assert inner + outer <= whole  # the inner span's seconds are not the outer's too


def test_span_is_a_record_function_under_the_profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("graph.replay"):
            torch.zeros(2)
    (replay,) = [e for e in prof.events() if e.name == "plt.graph.replay"]
    (zeros,) = [e for e in prof.events() if e.name == "aten::zeros"]
    assert replay.time_range.start <= zeros.time_range.start
    assert zeros.time_range.end <= replay.time_range.end


def test_snapshot_is_a_copy():
    trace.count("a", 3)
    with trace.setup_span("setup.y"):
        pass
    snap = trace.snapshot()
    trace.count("a")
    snap["totals"]["setup.y"][1] = 99
    assert snap["counters"]["a"] == 3
    assert trace.snapshot() == {"totals": {"setup.y": [pytest.approx(snap["totals"]["setup.y"][0]), 1]},
                                "counters": {"a": 4}}
    trace.reset()
    assert trace.snapshot() == {"totals": {}, "counters": {}}


def test_kernel_builds_are_a_setup_span(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "lib_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build, "_compile", lambda todo: {n: 0.5 for n in todo})
    assert _build.build(["int8_gemm", "nms"]) == {"int8_gemm": 0.5, "nms": 0.5}
    snap = trace.snapshot()
    assert snap["counters"]["kernels.builds"] == 2
    assert snap["totals"]["setup.kernels_build"][1] == 1
    (tmp_path / "libnms.so").write_bytes(b"")
    (tmp_path / "libint8_gemm.so").write_bytes(b"")
    assert _build.build(["int8_gemm", "nms"]) == {}  # nothing missing: no span
    assert trace.snapshot()["totals"]["setup.kernels_build"][1] == 1


class _Held:
    """A predictor whose first call waits until released."""

    def __init__(self, release: threading.Event, started: threading.Event):
        self.release, self.started = release, started

    def run(self, inputs):
        self.started.set()
        assert self.release.wait(timeout=10)
        return {"y": np.asarray(inputs["x"]) * 2}


def test_batcher_reports_the_queue_wait():
    release, started = threading.Event(), threading.Event()
    wait_s = 0.2
    batcher = ContinuousBatcher(lambda b: _Held(release, started),
                                BatcherConfig(buckets=(1,), max_wait_ms=0.0))
    try:
        first = batcher.submit({"x": np.ones(3, np.float32)})
        assert started.wait(timeout=10)
        second = batcher.submit({"x": np.full(3, 2.0, np.float32)})
        time.sleep(wait_s)  # the second request waits in the queue all this time
        release.set()
        assert np.array_equal(first.result(timeout=10)["y"], np.full(3, 2.0))
        assert np.array_equal(second.result(timeout=10)["y"], np.full(3, 4.0))
    finally:
        batcher.close()
    assert not batcher._thread.is_alive()
    st = batcher.stats
    assert st["requests"] == 2 and st["batches"] == 2
    assert st["queue_wait_max_s"] >= wait_s
    assert st["queue_wait_s"] >= st["queue_wait_max_s"]


def test_batcher_spans_under_the_profiler():
    # the dispatcher's own thread shows where the profiler records every
    # thread, not only the one that started it
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    batcher = ContinuousBatcher(lambda b: create_predictor(_graph(b), device="cpu"),
                                BatcherConfig(buckets=(2,), max_wait_ms=50.0))
    try:
        batcher.infer({"x": _feed(0, 1)["x"][0]}, timeout=30)  # the bucket is built
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    experimental_config=every_thread) as prof:
            futs = [batcher.submit({"x": _feed(s, 1)["x"][0]}) for s in range(2)]
            for f in futs:
                (out,) = f.result(timeout=30).values()
                assert out.shape == (3,)
    finally:
        batcher.close()
    names = {e.name for e in prof.events()}
    assert {"plt.batcher.collect", "plt.batcher.dispatch", "plt.batcher.stack",
            "plt.predictor.run"} <= names


def test_counters_lose_no_update_under_threads():
    threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                trace.count("hits")
                trace.count("bytes", 3)

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    c = trace.snapshot()["counters"]
    assert c["hits"] == threads * per and c["bytes"] == 3 * threads * per


def test_chrome_trace_shows_the_program_spans(tmp_path):
    pred = create_predictor(_graph(), device="cpu")
    feed = _feed(0)
    with trace_tool.trace(str(tmp_path)) as t:
        with trace_tool.annotate("request"):
            pred.run(feed)
    text = open(t.path).read()
    for name in ("request", "plt.predictor.run") + REQUEST_SPANS:
        assert name in text, name
