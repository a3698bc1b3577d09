"""One run of one cell: set-up, the window, the check, the metrics.

Everything a cell is made of is found by name, from ``BENCHMARK.json``:

- the configuration's file (``configs/<config>.json``): its sizes, the
  program's model-building function and ``QuantConfig``, and the names of
  its family (``families/<family>.py``: how its weights, inputs, predictor,
  reference and comparison are made) and of its plain reference
  (``reference/<name>.py``);
- the traffic mix (``traffic/<traffic>.json``), read by :mod:`.traffic`;
- each metric's reader (``metrics/<metric>.py``, a ``read(r)`` that returns a
  number or None);
- the limits of the check (``limits/<workload>.json``).

Set-up makes the weights, the calibration inputs and the traffic's pool on
the device from the seed, builds the program's predictor at the traffic's
batch (one a bucket for served traffic), and warms up every predictor the
traffic will call.  After the window the program's predictors are freed and
the reference, given the same weights and inputs, recomputes each checked
answer.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from . import costs, traffic
from .trace import Tracer

ROOT = Path(__file__).resolve().parents[1]
TRACE_START = 0.25  # of the window, where the traced stretch begins
TRACE_LENGTH_S = 2.0  # and its length, at most half the window


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of `workload` prints: its end-to-end ones, or with
    `trace` its per-layer ones."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def load_reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class Cell:
    """A cell's parts, loaded by name: a workload of ``BENCHMARK.json``, or
    a configuration and a traffic mix named directly (``workload`` None)."""

    def __init__(self, root: Path, workload: str = None, config: str = None,
                 mix: str = None):
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        if workload is not None:
            entry = find(self.bench["workloads"], workload, "workload")
            config, mix = entry["config"], entry["traffic"]
            self.limits = load_json(root / "benchmark" / "limits" / f"{workload}.json")
        else:
            self.limits = {}
        self.name = workload
        self.cfg = load_json(root / find(self.bench["configs"], config, "config")["file"])
        self.family = importlib.import_module(f"benchmark.families.{self.cfg['family']}")
        self.mix = traffic.load(root, mix)


class Run:
    """Set-up, window and check of one run; :meth:`result` is the line."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, t_process: float):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.t_process = device, t_process
        self.tracer = (Tracer(TRACE_START * seconds, min(TRACE_LENGTH_S, seconds / 2),
                              sync=cell.mix["kind"] == "closed") if trace else None)

    # ---- set-up --------------------------------------------------------
    def setup(self) -> None:
        cell, fam, dev = self.cell, self.cell.family, self.device
        self.phases = {"start": time.time() - self.t_process}
        t = time.perf_counter()
        gen = generator(self.seed, dev)
        self.made = fam.make(cell.cfg, gen, dev)
        self.phases["weights"] = time.perf_counter() - t
        mix = cell.mix
        if mix["kind"] == "closed":
            b = int(mix["batch"])
            pool = [fam.inputs(cell.cfg, gen, b, dev) for _ in range(int(mix["pool_batches"]))]
            self.pool = pool if mix["input"] == "card" else [x.cpu().numpy() for x in pool]
            self.pred = fam.build(cell.cfg, self.made, b, dev)
            self.phases["build"] = time.perf_counter() - t
            self.graph = self.pred.graph
            self.feeds = [fam.feed(self.pred, x) for x in self.pool]
            for f in self.feeds + self.feeds:  # the first call warms up and captures
                self.pred.run(f)
            if self.tracer is not None:
                Tracer.warm(lambda: self.pred.run(self.feeds[0]))
        else:
            from paddle_lite_tpu_torch.runtime.batcher import BatcherConfig

            rows = fam.inputs(cell.cfg, gen, int(mix["pool_images"]), dev).cpu().numpy()
            self.pool = [rows[i:i + 1] for i in range(len(rows))]
            self.bconfig = BatcherConfig(**mix.get("batcher", {}))
            self.preds = {b: fam.build(cell.cfg, self.made, b, dev)
                          for b in self.bconfig.buckets}
            self.phases["build"] = time.perf_counter() - t
            self.graph = self.preds[max(self.preds)].graph
            for b, p in self.preds.items():
                f = fam.feed(p, np.repeat(rows[:1], b, axis=0))
                p.run(f)
                p.run(f)
            if self.tracer is not None:
                Tracer.warm(lambda: p.run(f))
            self.start_batcher()
        # what set-up made lives to the end: out of the collector's scans,
        # so a full collection in the window does not walk it
        gc.collect()
        gc.freeze()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        self.phases["warm"] = time.perf_counter() - t

    def start_batcher(self) -> None:
        """A batcher over the bucket predictors, its own path run once at
        its largest bucket and at one request."""
        from paddle_lite_tpu_torch.runtime.batcher import ContinuousBatcher

        fam = self.cell.family
        self.done: Dict[int, tuple] = {}
        timed = {b: traffic.Timed(p, self.done) for b, p in self.preds.items()}
        self.batcher = ContinuousBatcher(lambda b: timed[b], self.bconfig)
        p = self.preds[min(self.preds)]
        # a request is one image, without the batch axis: the batcher stacks them
        self.request_feeds = [fam.feed(p, x[0]) for x in self.pool]
        futs = [self.batcher.submit(self.request_feeds[i % len(self.pool)])
                for i in range(max(self.bconfig.buckets))]
        for f in futs:
            f.result(timeout=120)
        self.batcher.submit(self.request_feeds[0]).result(timeout=120)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.done.clear()

    # ---- window --------------------------------------------------------
    def window(self) -> None:
        self.setup_s = time.time() - self.t_process
        mix, fam = self.cell.mix, self.cell.family
        if mix["kind"] == "closed":
            self.out = traffic.run_closed(
                self.pred, self.feeds, lambda o: fam.answer(self.pred, o), mix,
                self.seconds, self.seed, self.device, self.tracer)
            self.counters = {}
        else:
            before = dict(self.batcher.stats)
            p = self.preds[min(self.preds)]
            try:
                self.out = traffic.run_poisson(
                    self.batcher, self.request_feeds, lambda o: fam.answer(p, o), mix,
                    self.seconds, self.seed, self.done, self.tracer)
            finally:
                self.batcher.close()
            self.counters = {k: v - before[k] for k, v in self.batcher.stats.items()}
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)
        self.trace_summary = self.tracer.summary() if self.tracer else None

    # ---- check ---------------------------------------------------------
    def free_program(self) -> None:
        for name in ("pred", "preds", "batcher", "done", "feeds", "request_feeds"):
            if hasattr(self, name):
                delattr(self, name)
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, low: bool = False) -> torch.Tensor:
        """The reference's answers to every input of the traffic's pool (a
        closed loop's batches one after another, or a served pool's
        images), float64 on the device; with `low` the control's."""
        cell, dev = self.cell, self.device
        ref = cell.family.Reference(cell.cfg, self.made, dev)
        block = int(cell.cfg["reference_block"])
        x = torch.cat([torch.as_tensor(p, device=dev) for p in self.pool])
        return torch.cat([ref(x[i:i + block], low) for i in range(0, len(x), block)])

    def checked(self) -> List[tuple]:
        """(answers, index of each answer's input in the pool) of every
        checked answer: the kept calls' answers, or the answered requests'
        rows."""
        dev = self.device
        if self.cell.mix["kind"] == "closed":
            b = int(self.cell.mix["batch"])
            return [(got, torch.arange(k * b, (k + 1) * b, device=dev))
                    for k, got in self.out["kept"]]
        ok = [i for i, r in enumerate(self.out["rows"]) if r is not None]
        if not ok:
            return []
        got = torch.from_numpy(np.stack([self.out["rows"][i] for i in ok])).to(dev)
        return [(got, torch.as_tensor(self.out["choice"][ok], device=dev))]

    def unanswered(self) -> int:
        if self.cell.mix["kind"] == "closed":
            return 0
        return sum(r is None for r in self.out["rows"])

    def compare(self, pool: torch.Tensor, answers) -> Dict[str, float]:
        """The family's numbers over `answers`, (rows, pool index) pairs:
        the worst row of each."""
        worst: Dict[str, float] = {}
        for got, idx in answers:
            for k, v in self.cell.family.compare(got, pool, idx).items():
                worst[k] = max(worst.get(k, -math.inf), float(v.max()))
        return worst

    def check(self) -> dict:
        """The numbers compared, each with its value and limit."""
        t0 = time.perf_counter()
        got = self.compare(self.reference(), self.checked())
        self.check_s = time.perf_counter() - t0
        out = {k: {"value": got.get(k, float("nan")), "limit": v}
               for k, v in self.cell.limits.items()}
        out["unanswered"] = {"value": self.unanswered(), "limit": 0}
        return out

    # ---- the line ------------------------------------------------------
    def readings(self) -> SimpleNamespace:
        peaks = costs.peaks_for(self.device_name()) if self.trace_summary else None
        return SimpleNamespace(mix=self.cell.mix, setup_s=self.setup_s, window=self.out,
                               counters=self.counters, trace=self.trace_summary,
                               graph=self.graph, peaks=peaks)

    def device_name(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"

    def result(self, check: dict) -> dict:
        cell = self.cell
        r = self.readings()
        metrics = {}
        for m in metrics_for(cell.bench, cell.name, self.trace):
            v = load_reader(cell.root, m["name"])(r)
            if v is None:
                print(f"metric {m['name']}: nothing to read in this run", file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        correct = all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
                      for c in check.values())
        if cell.mix["kind"] == "closed":
            attempted = self.out["calls"] * int(cell.mix["batch"])
            failed = 0
        else:
            attempted = self.out["n"]
            failed = check["unanswered"]["value"]
        device = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
                  "kind": self.device_name(), "count": 1,
                  "memory_peak_bytes": int(self.memory_peak)}
        line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
                "metrics": metrics, "device": device}
        if self.trace_summary is not None:
            device["busy_s"] = self.trace_summary["busy_s"]
            device["window_s"] = self.trace_summary["window_s"]
            line["breakdown"] = {"device_ops": self.trace_summary["device_ops"],
                                 "idle_gaps": self.trace_summary["idle_gaps"]}
        line["check"] = check
        return line
