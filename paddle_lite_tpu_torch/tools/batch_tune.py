"""Measure a model's throughput at each batcher bucket and merge it into the
port's batch table (``runtime/batch_table.py``); port of
``paddle_lite_tpu/tools/batch_tune.py``.

    python3 -m paddle_lite_tpu_torch.tools.batch_tune --model mobilenet_v1 \\
        [--buckets 1,2,4,8,16,32,64] [--fp32] [--table-dir DIR]

Each bucket is measured by ``tools.benchmark.bench_model`` (the
iteration-delta method on the card, one bucket at a time); the rows merge
into the model's entry, so re-tuning some buckets keeps the others, and
each row records the card and its power limit.
"""

from __future__ import annotations

import argparse
import json


def main() -> None:
    from ..core.device import resolve_device
    from ..runtime.batch_table import load_entry, save_rows
    from . import benchmark

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True)
    p.add_argument("--buckets", default="1,2,4,8,16,32,64")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--fp32", action="store_true", help="measure fp32 instead")
    p.add_argument("--table-dir", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    dev = resolve_device(args.device)
    where = benchmark.card(dev)
    key = "fp32_items_per_sec" if args.fp32 else "int8_items_per_sec"
    rows = {}
    for b in (int(x) for x in args.buckets.split(",")):
        r = benchmark.bench_model(args.model, batch=b, image_size=args.image_size,
                                  int8=not args.fp32, with_fp32=args.fp32, device=dev)
        rows[b] = r[key]
        print(json.dumps({"bucket": b, "items_per_sec": r[key], "device": where}),
              flush=True)
    save_rows(args.model, rows, card=where["name"], power_limit=where["power_limit"],
              table_dir=args.table_dir)
    merged = load_entry(args.model, args.table_dir)
    best = max(merged, key=merged.get) if merged else None
    print(json.dumps({"model": args.model, "best_bucket": best,
                      "table": merged, "device": where}))


if __name__ == "__main__":
    main()
