"""Host-side IO threading: a copy of ``adipose_tpu/core/hostio.py``.

cv2's codecs release the GIL, so decode and encode overlap across threads.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
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
