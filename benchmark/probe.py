"""Readings that the limits of the check are set from, for one cell.

    python3 -m benchmark.probe --workload <name> --seeds 1,2,3 --control-seeds 1,2,3 \\
        [--seconds 2] [--out probe.jsonl]

In one process: for each seed a whole run of the cell (set-up, a window of
``--seconds``, the check) prints the program's reading of each number
compared.  For each control seed it prints besides what the check would
read under the control and under each fault a closed loop can have, worked
out from the same kept answers:

- ``control``: the plain reference at the precision below the
  configuration's (int4 for int8) in the program's place;
- ``stale``: each call answered with the program's answers to the previous
  pool batch (a static input buffer not refreshed);
- ``half_stale``: the second half of each call's rows left from the
  previous pool batch's answers;
- ``swap``: a call's first two answers exchanged, the smallest over the
  kept calls.

One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .cell import ROOT, Cell, Run
from .run import T_PROCESS, cache_env


def fault_readings(run: Run) -> dict:
    """The check's readings under the control and the faults (see above)."""
    pool = run.reference()
    kept = run.checked()
    out = {"control": run.compare(pool, [(run.reference(low=True)[idx], idx)
                                         for _, idx in kept])}
    if run.cell.mix["kind"] != "closed":
        return out
    b = int(run.cell.mix["batch"])
    n = len(pool) // b
    # the program's own answers to each pool batch, from the kept calls
    answers = {int(idx[0]) // b: got.to(pool.device, torch.float64) for got, idx in kept}
    if len(answers) < n:
        return out
    out["stale"] = run.compare(pool, [(answers[(int(idx[0]) // b - 1) % n], idx)
                                      for _, idx in kept])
    half = []
    for got, idx in kept:
        g = got.to(pool.device, torch.float64).clone()
        g[b // 2:] = answers[(int(idx[0]) // b - 1) % n][b // 2:]
        half.append((g, idx))
    out["half_stale"] = run.compare(pool, half)
    swaps = [run.compare(pool, [(got[[1, 0]], idx[:2])]) for got, idx in kept]
    out["swap"] = {m: min(s[m] for s in swaps) for m in swaps[0]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cache_env(ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = Run(Cell(ROOT, args.workload), seed, args.seconds, False, dev, T_PROCESS)
        run.setup()
        run.window()
        run.free_program()
        check = run.check()
        row = {"workload": args.workload, "seed": seed, "check_s": run.check_s,
               **{k: c["value"] for k, c in check.items()}, **run.made.info}
        if seed in controls:
            row.update(fault_readings(run))
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
