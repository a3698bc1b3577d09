"""The knee sweep of a served mix: the same set-up, then one window at each
offered rate, in one process.

    python3 -m benchmark.sweep --config resnet50_int8 --traffic poisson_800 \\
        --rates 800,1200,1600 [--seconds 10] [--seed 1] [--out sweep.jsonl]

For each rate it prints the requests due, the backlog at the window's close
(due and not yet answered), the latency's p50 / p95 / p99, the batcher's
mean batch and the generator's p99 lateness.  A rate is sustained when the
backlog at the close is no larger than the largest bucket.  A served cell
whose tail is its end-to-end metric takes 0.8 of the highest rate sustained.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import traffic
from .cell import ROOT, Cell, Run
from .run import T_PROCESS, cache_env


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cache_env(ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(ROOT, config=args.config, mix=args.traffic)
    if cell.mix["kind"] != "poisson":
        print(f"{args.traffic} is not a served mix", file=sys.stderr)
        return 2
    run = Run(cell, args.seed, args.seconds, False, torch.device("cuda", 0), T_PROCESS)
    run.setup()
    run.batcher.close()
    largest = max(run.bconfig.buckets)
    for rate in [float(r) for r in args.rates.split(",")]:
        mix = dict(cell.mix, rate_per_s=rate)
        run.start_batcher()
        before = dict(run.batcher.stats)
        try:
            p = run.preds[min(run.preds)]
            out = traffic.run_poisson(run.batcher, run.request_feeds,
                                      lambda o: cell.family.answer(p, o), mix,
                                      args.seconds, args.seed, run.done)
        finally:
            run.batcher.close()
        st = {k: v - before[k] for k, v in run.batcher.stats.items()}
        lat = 1e3 * out["latency_s"]
        row = {"config": args.config, "traffic": args.traffic, "rate_per_s": rate, "due": out["n"],
               "backlog_at_close": out["backlog"], "sustained": out["backlog"] <= largest,
               "unanswered": int((~out["answered"]).sum()),
               "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
               "p99_ms": float(np.percentile(lat, 99)),
               "batch_mean": st["requests"] / max(st["batches"], 1),
               "late_p99_ms": 1e3 * out["late_p99_s"],
               "device": torch.cuda.get_device_name(0)}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
