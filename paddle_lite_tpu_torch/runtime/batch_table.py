"""Per-model best-batch tables for the continuous batcher.

Port of ``paddle_lite_tpu/runtime/batch_table.py``: items/s measured per
bucket size, which the batcher reads to cap its bucket ladder at the
model's best batch and to send ``n`` requests to the bucket that serves
them fastest.  ``python3 -m paddle_lite_tpu_torch.tools.batch_tune --model
mobilenet_v1`` measures and stores a table on the card.

The table is ``batch.json`` in the port's own directory
(``paddle_lite_tpu_torch/_tuning/``, listed in ``.gitignore``), never the
reference's ``.autotune/``, whose numbers were measured on a TPU.  Each row
records the card's name and power limit beside its items/s::

    {"mobilenet_v1": {"64": {"items_per_s": 30000.0,
                             "card": "NVIDIA H100 80GB HBM3",
                             "power_limit": "700.00 W"}, ...}}

Three faults of the reference are not copied:

- the batcher reads a model's entry once, when it is built
  (:func:`load_entry`), not on every dispatched batch (``batcher.py:111``
  → ``batch_table.py:77`` there);
- :func:`best_bucket` considers only measured batches up to the ladder's
  largest bucket (the reference ignores the cap, ``batch_table.py:58-61``);
- a zero, negative or non-finite entry counts as unmeasured (the
  reference divides by it, ``batch_table.py:80``).
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Dict, Optional, Sequence

DEFAULT_DIR = Path(__file__).resolve().parents[1] / "_tuning"


def _path(table_dir: Optional[str]) -> Path:
    return Path(table_dir) if table_dir else DEFAULT_DIR


def load_table(table_dir: Optional[str] = None) -> Dict[str, Dict[str, dict]]:
    p = _path(table_dir) / "batch.json"
    if not p.is_file():
        return {}
    with open(p) as f:
        return json.load(f)


def load_entry(model: str, table_dir: Optional[str] = None) -> Dict[int, float]:
    """{batch: items/s} of `model`'s measured rows; rows without a
    positive, finite items/s are left out (unmeasured)."""
    rows = load_table(table_dir).get(model, {})
    out = {}
    for b, row in rows.items():
        v = float(row["items_per_s"])
        if v > 0 and math.isfinite(v):
            out[int(b)] = v
    return out


def save_rows(model: str, rows: Dict[int, float], *, card: str,
              power_limit: Optional[str], table_dir: Optional[str] = None) -> None:
    """Merge `rows` ({batch: items/s}, measured on `card` at `power_limit`)
    into `model`'s entry: rows of other batches stay."""
    d = _path(table_dir)
    d.mkdir(parents=True, exist_ok=True)
    table = load_table(table_dir)
    entry = table.setdefault(model, {})
    for b, v in rows.items():
        entry[str(int(b))] = {"items_per_s": float(v), "card": card,
                              "power_limit": power_limit}
    tmp = d / f"batch.json.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    os.replace(tmp, d / "batch.json")


def best_bucket(entry: Dict[int, float], buckets: Sequence[int]) -> Optional[int]:
    """The measured-throughput-optimal batch of `entry` among those up to
    ``max(buckets)`` (a peak may sit off the power-of-two ladder; the
    batcher adds it); None when no such batch was measured."""
    known = {b: v for b, v in entry.items() if b <= max(buckets)}
    if not known:
        return None
    return max(known, key=known.get)


def bucket_for(entry: Dict[int, float], n: int,
               buckets: Sequence[int]) -> Optional[int]:
    """Cliff-aware dispatch: among the buckets ``>= n`` that `entry`
    measured, the one with the lowest absolute time for a batch,
    ``bucket / items_per_s`` (a larger bucket can be faster in absolute
    time than a smaller one).  None when none of them was measured (the
    caller takes the smallest fit)."""
    cands = {b: b / entry[b] for b in buckets if b >= n and b in entry}
    if not cands:
        return None
    return min(cands, key=cands.get)
