"""Host-side IO: threading (a copy of ``adipose_tpu/core/hostio.py``) and
the CSV tables the JAX package writes with pandas.

cv2's codecs release the GIL, so decode and encode overlap across threads.
"""

from __future__ import annotations

import csv
import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, TypeVar

_T = TypeVar("_T")
_R = TypeVar("_R")


def io_workers(cap: int = 8) -> int:
    """Worker count for GIL-releasing codec work: min(cap, cpu_count)."""
    return max(1, min(cap, os.cpu_count() or 1))


def thread_map(fn: Callable[[_T], _R], items: Iterable[_T],
               cap: int = 8) -> list[_R]:
    """Order-preserving parallel map for IO/codec-bound ``fn``.

    Exceptions propagate like a plain ``map``. Results are fully
    materialized: use for bounded batches, not unbounded streams.
    """
    with ThreadPoolExecutor(max_workers=io_workers(cap)) as ex:
        return list(ex.map(fn, items))


def write_csv(path: str | Path, rows: list[dict]) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False)`` for rows of equal
    keys: a header of the first row's keys, ``repr`` floats, NaN as an empty
    field, '\n' line ends; no rows is one empty line."""
    with Path(path).open("w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(rows[0]))
        for row in rows:
            writer.writerow(["" if isinstance(v, float) and math.isnan(v) else v
                             for v in row.values()])
