"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  The cell's
configuration, traffic, metrics and limits are found by name through
``BENCHMARK.json`` (see ``benchmark/README.md``).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number compared with its limit, also printed as the last
lines of standard error.

Exits non-zero, printing no result, without a card, or if JAX or the JAX
package was loaded into the process by the end of the window.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "paddle_lite_tpu")


def process_start() -> float:
    """This process's start on the wall clock (Linux), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + start / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROCESS = process_start()


def cache_env(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout."""
    cache = root / "benchmark" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env(ROOT)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card", file=sys.stderr)
        return 2
    import json

    from .cell import Cell, Run

    run = Run(Cell(ROOT, args.workload), args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), T_PROCESS)
    run.setup()
    run.window()
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    run.free_program()
    check = run.check()
    line = run.result(check)
    if run.cell.mix["kind"] == "poisson":
        import numpy as np

        lat = 1e3 * run.out["latency_s"]
        print(f"window: {run.out['n']} requests, p50 {np.percentile(lat, 50):.3f} ms, "
              f"p99 {np.percentile(lat, 99):.3f} ms, backlog at close {run.out['backlog']}, "
              f"generator late p99 {1e3 * run.out['late_p99_s']:.3f} ms, batcher {run.counters}",
              file=sys.stderr)
    phases = " ".join(f"{k} {v:.3f}" for k, v in run.phases.items())
    print(f"setup {run.setup_s:.3f} s (at the end of: {phases}); check {run.check_s:.3f} s",
          file=sys.stderr)
    for k, c in check.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
